"""The port's CUDA kernels against their plain twins, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one. Run on a machine with an H100: ``python -m pytest -m gpu
--noconftest tests/test_torch_gpu.py``. Kernel and twin share every
rounding site, so they differ only where an f32 sum in another order flips
a bf16 rounding: max-abs 1e-2 and rel-L2 2e-3 for the forward kernels, and
the backward kernel's limits of chip_smoke.py.
"""

import pytest
import torch

from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.gpu

MAX_ABS, REL_L2 = 1e-2, 2e-3
BWD_MAX_ABS, BWD_REL_L2 = 5e-3, 5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(gen, *shape, std=1.0, dtype=torch.bfloat16):
    dev = gen.device
    return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)


def _agree(out, ref, max_abs=MAX_ABS, rel_l2=REL_L2):
    a, b = out.float(), ref.float()
    assert torch.isfinite(a).all()
    assert float((a - b).abs().max()) <= max_abs
    assert float((a - b).norm() / b.norm()) <= rel_l2


@pytest.mark.parametrize("b,l,h", [(2, 17, 4), (3, 257, 16), (2, 334, 16),
                                   (1, 512, 2), (1, 1, 1)])
def test_kernels_match_twins(cuda, b, l, h):
    g = torch.Generator(device=cuda).manual_seed(l)
    c = 64 * h
    x = _rand(g, b, l, c)
    w = _rand(g, c, 3 * c, std=c ** -0.5)
    qkv = _rand(g, b, l, 3 * c)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    s = 0.125
    _agree(attn.fused_qkv_attention(qkv, h),
           attn.packed_attention_plain(qkv, h, s))
    _agree(attn.fused_qkvproj_attention(x, w, h),
           attn.qkvproj_attention_plain(x, w, h, s))
    _agree(attn.fused_ln_qkvproj_attention(x, lns, lnb, w, h),
           attn.ln_qkvproj_attention_plain(x, lns, lnb, w, h, s, 1e-5))


@pytest.mark.parametrize("b,l,h", [(1, 1, 1), (2, 17, 4), (2, 257, 16),
                                   (2, 334, 16), (1, 512, 2)])
def test_backward_kernel_matches_twin(cuda, b, l, h):
    """L = 512 is the shared-memory limit of both backward kernels."""
    g = torch.Generator(device=cuda).manual_seed(l + 1)
    qkv = _rand(g, b, l, 3 * 64 * h, std=0.64)
    do = _rand(g, b, l, 64 * h)
    _agree(attn.packed_attention_bwd(qkv, do, h),
           attn.packed_attention_bwd_plain(qkv, do, h, 0.125),
           BWD_MAX_ABS, BWD_REL_L2)


def test_backward_kernel_refuses(cuda):
    qkv = torch.zeros(1, 8, 384, dtype=torch.bfloat16, device=cuda)
    do = torch.zeros(1, 8, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        attn.packed_attention_bwd(qkv.float(), do.float(), 2)
    with pytest.raises(ValueError, match="do must be"):
        attn.packed_attention_bwd(qkv, do.float(), 2)
    with pytest.raises(ValueError, match="shape"):
        attn.packed_attention_bwd(qkv, do[:, :4], 2)
    with pytest.raises(ValueError, match="is on"):
        attn.packed_attention_bwd(qkv, do.cpu(), 2)
    with pytest.raises(ValueError, match="L <="):
        attn.packed_attention_bwd(
            torch.zeros(1, 513, 384, dtype=torch.bfloat16, device=cuda),
            torch.zeros(1, 513, 128, dtype=torch.bfloat16, device=cuda), 2)


def test_wrappers_count_launches_and_refuse(cuda):
    attn.reset_launches()
    x = torch.zeros(1, 8, 128, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(128, 384, dtype=torch.bfloat16, device=cuda)
    attn.fused_qkvproj_attention(x, w, 2)
    qkv = torch.zeros(1, 8, 384, dtype=torch.bfloat16, device=cuda,
                      requires_grad=True)
    attn.fused_qkv_attention(qkv, 2).sum().backward()
    torch.cuda.synchronize()
    assert attn.LAUNCHES == {"packed_attention": 1, "qkvproj_attention": 1,
                             "ln_qkvproj_attention": 0,
                             "packed_attention_bwd": 1}
    with pytest.raises(ValueError, match="bfloat16"):
        attn.fused_qkvproj_attention(x.float(), w, 2)
    with pytest.raises(ValueError, match="L <="):
        attn.fused_qkv_attention(torch.zeros(1, 513, 384, dtype=torch.bfloat16,
                                             device=cuda), 2)
    with pytest.raises(ValueError, match="is on"):
        attn.fused_qkvproj_attention(x, w.cpu(), 2)
    with pytest.raises(NotImplementedError, match="inference-only"):
        attn.fused_ln_qkvproj_attention(
            x, torch.ones(128, device=cuda), torch.zeros(128, device=cuda),
            w.requires_grad_(), 2)


def test_uvit_auto_routes_through_the_kernel(cuda):
    cfg = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=128, depth=2,
               num_heads=2, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    fused = UViT(**cfg).init_weights(g).eval()
    plain = UViT(attn_impl="xla", **cfg).eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(4, 8, 8, 4, generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    attn.reset_launches()
    with torch.no_grad():
        a, _ = fused(x, t)
        b, _ = plain(x, t)
    assert attn.LAUNCHES["qkvproj_attention"] == 3
    assert float((a.float() - b.float()).norm() / b.float().norm()) < 2e-2


def test_uvit_kernel_gradients_match_plain(cuda):
    """f32 masters, bf16 compute, full remat: the pallas_packed and auto
    views' gradients against the plain path's (xla attention)."""
    cfg = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=128, depth=2,
               num_heads=2, dtype=torch.bfloat16, param_dtype=torch.float32,
               use_checkpoint=True, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    models = {impl: UViT(attn_impl=impl, **cfg)
              for impl in ("xla", "pallas_packed", "auto")}
    models["xla"].init_weights(g)
    for m in models.values():
        m.load_state_dict(models["xla"].state_dict())
    x = torch.randn(4, 8, 8, 4, generator=g, device=cuda)
    t = torch.rand(4, generator=g, device=cuda)
    grads = {}
    attn.reset_launches()
    for impl, m in models.items():
        v, _ = m(x, t)
        params = list(m.parameters())
        grads[impl] = torch.cat([p.flatten() for p in torch.autograd.grad(
            v.float().square().mean(), params)])
    assert attn.LAUNCHES["packed_attention_bwd"] == 6
    assert attn.LAUNCHES["packed_attention"] == 6  # 3 blocks, rematted
    ref = grads["xla"]
    for impl in ("pallas_packed", "auto"):
        rel = float((grads[impl] - ref).norm() / ref.norm())
        assert rel < 2e-2, (impl, rel)
