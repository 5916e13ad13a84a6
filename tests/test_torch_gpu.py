"""The port's CUDA kernels against their plain twins, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one. Run on a machine with an H100: ``python -m pytest -m gpu
--noconftest tests/test_torch_gpu.py``. Kernel and twin share every
rounding site, so they differ only where an f32 sum in another order flips
a bf16 rounding: max-abs 1e-2 and rel-L2 2e-3 for the forward kernels, and
the backward kernel's limits of chip_smoke.py. The int8 kernels may also
flip an int8 code by one step where an f32 sum (LN statistics) runs in
another order: max-abs one bf16 step of the largest output value, and the
int8 rel-L2 limits of chip_smoke.py, taken for the MLP sub-block on out - x
(the residual would dilute an error of the MLP). The weight-only int8 (w8)
MLP kernels are held the same way, at chip_smoke.py's w8 limit; the
pieces of the w8 sub-block (row 16) alone: its LN pass bit-equal to the
bf16-chain twin in the kernel's lane order, its fc1 and fc2 GEMMs within one
bf16 step (plus f32 reordering) of the f32 product. The pieces of the
int8 LN + QKV-projection route (row 5) alone: its code pass bit-equal to
``row_codes(ln_lanes(x))`` (codes and row scales), its int8 GEMM's qkv
workspace bit-equal to the dequantised int32 product. The packed backward
(row 4) at the edges of its tiles, repeats bit-equal. The
[B, H, L, D] kernel (kernel 7) and the blocked online-softmax kernel
(kernel 9) take the bf16 forward limits. The bf16
attention sub-block and the bf16 MLP kernels (rows 10, 12, 13) take the
bf16 rel-L2, the int8 sub-block (row 11) the int8 attention one; the bf16
MLP max-abs one bf16 step of its largest output (its outputs pass 2, where
a step exceeds 1e-2), each sub-block one step of its largest update plus
one of its largest output (its bf16 residual add rounds a second time) and
rel-L2 on its update out - x; the pieces of
the bf16 MLP (rows 12 and 13) alone as row 16's, every repeat bit-equal. The stage-delta kernels (rows 18 to 25 of
the kernel table, in the three hidden modes) take the int8 limits: the base kernels on every output, caches
included (codes one step apart at most, scales within 1e-6), the delta
kernels on what they add to the cache (``xm - xm_b``, ``o - x - m_b``) with
one bf16 step of that part plus one of the output; row 18's two GEMM
passes alone, and its cache over all Lp rows, bit-equal to their twins.
Row 19's twin takes row
1's kernel as its attention core here: the core's own bf16 steps pass
through ``da = a - a_b`` at full size (chip_smoke.py phase 3 holds row 19
to the plain twin). A delta at the base's own point reproduces the base's
output exactly (in the "gelu" mode, row 24, within 5e-3: it re-rounds the
base's hidden residual).
"""

import math

import pytest
import torch

from uspace_tpu_torch.models import UNet, UViT
from uspace_tpu_torch.models.unet import ZERO_INIT_STD
from uspace_tpu_torch.core import delta_field
from uspace_tpu_torch.ops import attention as attn
from uspace_tpu_torch.ops import delta
from uspace_tpu_torch.ops import mlp
from uspace_tpu_torch.ops import quant

pytestmark = pytest.mark.gpu

MAX_ABS, REL_L2 = 1e-2, 2e-3
BWD_MAX_ABS, BWD_REL_L2 = 5e-3, 5e-4
INT8_ATTN_REL_L2, INT8_MLP_REL_L2 = 5e-4, 1e-4
W8_MLP_REL_L2 = 6e-4


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


def _agree_int8(out, ref, rel_l2, x=None):
    """The int8 limits: max-abs one bf16 step of max|ref|, rel-L2 of the
    kernel's part (``out - x`` where a residual x is given)."""
    a, b = out.double(), ref.double()
    assert torch.isfinite(a).all()
    top = float(b.abs().max())
    step = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    err = float((a - b).abs().max())
    assert err <= step, (err, step)
    if x is not None:
        a, b = a - x.double(), b - x.double()
    rel = float((a - b).norm() / b.norm()) if b.norm() > 0 else 0.0
    assert rel <= rel_l2, rel


@pytest.mark.parametrize("b,l,h", [(2, 17, 4), (3, 257, 16), (2, 334, 16),
                                   (1, 512, 2), (1, 1, 1), (5, 77, 2)])
def test_kernels_match_twins(cuda, b, l, h):
    """Rows 1-3. (5, 77, 2): B*L = 385 rows, not a multiple of the
    projection's 128-row tile, and 3C = 384 columns, not a multiple of its
    256-column tile."""
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


@pytest.mark.parametrize("scale", [-0.125, 0.0, 0.3])
def test_core_takes_any_scale(cuda, scale):
    """Pass 1 takes the row's max over the raw scores and scales it once
    (the min for a negative scale): the same m as the twin's max of the
    scaled scores."""
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = _rand(g, 2, 257, 3 * 64 * 4, std=0.64)
    _agree(attn.fused_qkv_attention(qkv, 4, scale),
           attn.packed_attention_plain(qkv, 4, scale))


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


@pytest.mark.parametrize("l", [1, 16, 17, 63, 64, 65, 128, 129, 257, 334,
                               512])
def test_backward_kernel_tile_edges_and_repeats(cuda, l):
    """Row 4 at the edges of its 64-row tiles and 128-row blocks (a last
    tile of at most 16 rows is a 16-row chunk; a warpgroup whose rows all
    lie past L leaves) with 16 heads and B = 3, so that a tensor-map box
    near row L of one batch element must not read the next one's rows:
    dqkv within the backward limits, two calls bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(7 * l)
    b, h = 3, 16
    qkv = _rand(g, b, l, 3 * 64 * h, std=0.64)
    do = _rand(g, b, l, 64 * h)
    out = attn.packed_attention_bwd(qkv, do, h)
    again = attn.packed_attention_bwd(qkv, do, h)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree(out, attn.packed_attention_bwd_plain(qkv, do, h, 0.125),
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


def _bf16_steps(out, ref32, a, w):
    """|out - ref32| in units of its bound: one bf16 step of each f32
    reference value plus twice the f32 sum's reordering bound K * 2^-24 *
    sum_k |a_k w_k| (kernel and reference each add in their own order)."""
    top = ref32.abs().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    reorder = 2 * a.shape[-1] * 2.0 ** -24 * (a.float().abs()
                                               @ w.float().abs().t())
    return float(((out.float() - ref32).abs() / (step + reorder)).max())


@pytest.mark.parametrize("rows,c", [(50 * 257, 1024), (7, 128), (33, 2048)])
def test_ln_rows_kernel_is_bit_exact(cuda, rows, c):
    """Row 3's LN pass equals its twin with the kernel's sum order
    (``delta.ln_lanes`` rounded to bf16) bit for bit, and the twin of the
    route (``ln_rows_plain``, torch's sum order) within one bf16 step."""
    g = torch.Generator(device=cuda).manual_seed(rows + c)
    x = (_rand(g, rows, c).float() * 3 + 0.5).to(torch.bfloat16)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    out = attn._ln_rows_kernel(x, lns, lnb, 1e-5)
    assert torch.equal(out, delta.ln_lanes(x, lns, lnb, 1e-5).to(out.dtype))
    ref = attn.ln_rows_plain(x, lns, lnb, 1e-5).float()
    step = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)
    assert float((out.float() - ref).abs().max()) <= step


@pytest.mark.parametrize("m,n,k", [(50 * 257, 3072, 1024), (385, 384, 128),
                                   (129, 3072, 1024), (1, 192, 64)])
def test_qkv_gemm_kernel_matches_f32_product(cuda, m, n, k):
    """The wgmma projection of rows 2 and 3 against the f32 product,
    element by element within one bf16 step (plus f32 reordering); rows
    past a 128-row tile and columns past a 256-column tile are neither
    read nor written; two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = _rand(g, m, k)
    w = _rand(g, n, k, std=k ** -0.5)
    guard = torch.full((m + 1, n), 7.0, dtype=torch.bfloat16, device=cuda)
    out = attn._qkv_gemm_kernel(a, w)
    ref32 = a.float() @ w.float().t()
    assert out.shape == (m, n) and torch.isfinite(out.float()).all()
    assert _bf16_steps(out, ref32, a, w) <= 1.0
    assert torch.equal(out, attn._qkv_gemm_kernel(a, w))
    # a ragged [m, n] output inside a larger buffer: the row past it stays
    lib = attn.load("attention")
    attn.raise_on(lib.uspace_qkv_gemm(
        a.data_ptr(), w.data_ptr(), guard.data_ptr(), m, n, k,
        attn.cuda_stream(a.device)), "uspace_qkv_gemm")
    assert torch.equal(guard[:m], out)
    assert bool((guard[m] == 7.0).all())


@pytest.mark.parametrize("rows,c", [(50 * 257, 1024), (1, 1024),
                                    (63, 1024), (129, 2048), (7, 128)])
def test_ln_codes_kernel_is_bit_exact(cuda, rows, c):
    """Row 5's code pass equals ``row_codes`` of the f32 LN rows with the
    kernel's sum order (``delta.ln_lanes``) bit for bit, codes and row
    scales."""
    g = torch.Generator(device=cuda).manual_seed(rows + c + 1)
    x = (_rand(g, rows, c).float() * 3 + 0.5).to(torch.bfloat16)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    codes, sr = attn._ln_codes_kernel(x, lns, lnb, 1e-5)
    ref_q, ref_s = quant.row_codes(delta.ln_lanes(x, lns, lnb, 1e-5))
    assert torch.equal(codes, ref_q)
    assert torch.equal(sr, ref_s.reshape(-1))


@pytest.mark.parametrize("m,n,k", [(50 * 257, 3072, 1024), (1, 3072, 1024),
                                   (63, 3072, 1024), (129, 3072, 1024),
                                   (385, 384, 128), (5, 192, 64)])
def test_qkv_gemm_int8_kernel_is_bit_exact(cuda, m, n, k):
    """Row 5's int8 wgmma projection: int32 sums are exact, so its qkv
    equals the dequantised product ``bf16((f32(acc) * sr) * ws)`` bit for
    bit; rows past a 128-row tile and columns past a 256-column tile are
    neither read nor written; two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k + 1)
    codes = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                          dtype=torch.int8)
    sr = torch.rand(m, generator=g, device=cuda) * 0.05 + 1e-3
    qw = quant.quantized_weight(_rand(g, k, n, std=k ** -0.5,
                                      dtype=torch.float32))
    out = attn._qkv_gemm_int8_kernel(codes, sr, qw)
    exact = torch.matmul(codes.double(), qw.kn.double()).to(torch.int32)
    ref = ((exact.float() * sr[:, None]) * qw.scale).to(torch.bfloat16)
    assert torch.equal(out, ref)
    assert torch.equal(out, attn._qkv_gemm_int8_kernel(codes, sr, qw))
    guard = torch.full((m + 1, n), 7.0, dtype=torch.bfloat16, device=cuda)
    attn.raise_on(attn.load("attention").uspace_qkv_gemm_int8(
        codes.data_ptr(), sr.data_ptr(), qw.q.data_ptr(), qw.scale.data_ptr(),
        guard.data_ptr(), m, n, k, attn.cuda_stream(cuda)),
        "uspace_qkv_gemm_int8")
    assert torch.equal(guard[:m], out)
    assert bool((guard[m] == 7.0).all())


def test_wrappers_count_launches_and_refuse(cuda):
    """One count per op call, though the bf16 projection routes launch two
    (row 2) or three (row 3) kernels."""
    attn.reset_launches()
    x = torch.zeros(1, 8, 128, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(128, 384, dtype=torch.bfloat16, device=cuda)
    attn.fused_qkvproj_attention(x, w, 2)
    with torch.no_grad():
        attn.fused_ln_qkvproj_attention(
            x, torch.ones(128, device=cuda), torch.zeros(128, device=cuda), w,
            2)
    qkv = torch.zeros(1, 8, 384, dtype=torch.bfloat16, device=cuda,
                      requires_grad=True)
    attn.fused_qkv_attention(qkv, 2).sum().backward()
    torch.cuda.synchronize()
    assert attn.LAUNCHES == {"packed_attention": 1, "qkvproj_attention": 1,
                             "ln_qkvproj_attention": 1,
                             "packed_attention_bwd": 1,
                             "qkvproj_attention_int8": 0,
                             "ln_qkvproj_attention_int8": 0,
                             "attention_fwd": 0, "fused_attention_bwd": 0,
                             "attention_block": 0,
                             "attention_block_int8": 0, "flash": 0}
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


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("b,l,c", [(2, 1, 128), (2, 17, 128), (2, 63, 256),
                                   (2, 65, 256), (3, 257, 1024),
                                   (1, 512, 256)])
def test_int8_attention_kernels_match_twins(cuda, b, l, c, d):
    """Rows 5, 6 and 11 at head dims 32 and 64 (rows 6 and 11 on row 5's
    pieces: a code pass, the int8 wgmma projection, row 1's core), each L
    a tile edge of the core (1, 63, 65, 257) or its limit (512)."""
    g = torch.Generator(device=cuda).manual_seed(l + 2 + d)
    h = c // d
    s = d ** -0.5
    x = _rand(g, b, l, c)
    w = _rand(g, c, 3 * c, std=c ** -0.5, dtype=torch.float32)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    qw = quant.quantized_weight(w)
    with torch.no_grad():
        _agree_int8(attn.fused_qkvproj_attention(x, w, h, quant=True),
                    attn.qkvproj_attention_int8_plain(x, qw, h, s),
                    INT8_ATTN_REL_L2)
        _agree_int8(attn.fused_ln_qkvproj_attention(x, lns, lnb, w, h,
                                                    quant=True),
                    attn.ln_qkvproj_attention_int8_plain(x, lns, lnb, qw, h,
                                                         s, 1e-5),
                    INT8_ATTN_REL_L2)
    xb, lns, lnb, wqkv, wproj, bproj = args = _block_args(g, b, l, c)
    qws = (quant.quantized_weight(wqkv), quant.quantized_weight(wproj))
    with torch.no_grad():
        out = attn.fused_attention_block_q(*args, h)
        again = attn.fused_attention_block_q(*args, h)
        _agree_update(out, attn.attention_block_int8_plain(
            xb, lns, lnb, *qws, bproj, h, s, 1e-5), xb, INT8_ATTN_REL_L2)
    assert torch.equal(out, again)


@pytest.mark.parametrize("rows,c", [(1, 1024), (33, 256), (500, 512),
                                    (12850, 1024)])
def test_int8_mlp_kernels_match_twins(cuda, rows, c):
    g = torch.Generator(device=cuda).manual_seed(rows)
    hid = 4 * c
    x = _rand(g, rows, c)
    w1 = _rand(g, c, hid, std=0.02, dtype=torch.float32)
    b1 = _rand(g, hid, std=0.02, dtype=torch.float32)
    w2 = _rand(g, hid, c, std=0.02, dtype=torch.float32)
    b2 = _rand(g, c, std=0.02, dtype=torch.float32)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    s = mlp.col_slices(hid)
    with torch.no_grad():
        _agree_int8(mlp.fused_mlp(x, w1, b1, w2, b2, quant=True),
                    mlp.mlp_int8_plain(x, q1, b1, q2, b2, s), INT8_MLP_REL_L2)
        _agree_int8(mlp.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2),
                    mlp.ln_mlp_int8_plain(x, lns, lnb, q1, b1, q2, b2, s,
                                          1e-5), INT8_MLP_REL_L2, x)


# (C, hidden) in 4 strips: hidden 4C (clusters of 1, 2 and 4 blocks a
# strip), strips narrower than C, and C = 128 (one K chunk in fc1)
INT8_MLP_WIDTHS = [(256, 1024), (512, 2048), (1024, 4096), (512, 1024),
                   (1024, 2048), (128, 1024)]


@pytest.mark.parametrize("c,hid", INT8_MLP_WIDTHS)
@pytest.mark.parametrize("rows", [1, 33, 500, 12850])
def test_int8_mlp_pieces_shapes_and_repeats(cuda, rows, c, hid):
    """Row 15's pieces at each of ``INT8_MLP_WIDTHS``: the code pass (LN2
    and the row codes of its bf16 rows in one pass) bit-equal to the
    bf16-chain twin in lane order, fc1's codes, scales and zero points
    bit-equal to ``mlp_int8_fc1_plain`` on those codes, fc2 bit-equal to
    ``mlp_int8_fc2_plain`` on fc1's hidden; the sub-block bit-equal to its
    pieces in sequence and to a repeat."""
    g = torch.Generator(device=cuda).manual_seed(3 * rows + c + hid)
    f32 = torch.float32
    x = _rand(g, rows, c)
    lns = 1 + _rand(g, c, std=0.1, dtype=f32)
    lnb = _rand(g, c, std=0.1, dtype=f32)
    w1 = _rand(g, c, hid, std=c ** -0.5, dtype=f32)
    b1 = _rand(g, hid, std=0.02, dtype=f32)
    w2 = _rand(g, hid, c, std=0.5 * hid ** -0.5, dtype=f32)
    b2 = _rand(g, c, std=0.02, dtype=f32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    s = mlp.col_slices(hid)
    with torch.no_grad():
        codes, sr = mlp._int8_codes_kernel(x, lns, lnb, 1e-5)
        ref_q, ref_s = quant.row_codes(_ln_chain_lanes(x, lns, lnb,
                                                       1e-5).float())
        hq, hsc, hzp = mlp._int8_fc1_kernel(codes, sr, q1, b1, s)
        twin = mlp.mlp_int8_fc1_plain(codes, sr[:, None], q1, b1, s)
        out = mlp._int8_fc2_kernel(hq, hsc, hzp, q2, b2, q2.colsums(s), x)
        ref = mlp.mlp_int8_fc2_plain(hq, hsc, hzp, q2, b2, x)
        block = mlp.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2)
        again = mlp.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(codes, ref_q) and torch.equal(sr, ref_s.reshape(-1))
    for got, want in zip((hq, hsc, hzp), twin):
        assert torch.equal(got, want)
    assert torch.equal(out, ref)
    assert torch.equal(block, out) and torch.equal(block, again)


@pytest.mark.parametrize("c,hid,out_dim",
                         [(c, h, c) for c, h in INT8_MLP_WIDTHS]
                         + [(256, 1024, 384)])
@pytest.mark.parametrize("rows", [1, 33, 500, 12850])
def test_int8_mlp_row14_shapes_and_repeats(cuda, rows, c, hid, out_dim):
    """Row 14 (the code pass of x's own rows, row 15's fc1, fc2 without the
    residual, from one C entry) at each of ``INT8_MLP_WIDTHS``, ragged row
    counts and an output width apart from C: bit-equal to its three piece
    twins in sequence (``row_codes`` of x, ``mlp_int8_fc1_plain``,
    ``mlp_int8_fc2_plain`` without the residual) and to a repeat."""
    g = torch.Generator(device=cuda).manual_seed(5 * rows + c + hid
                                                 + out_dim)
    f32 = torch.float32
    x = _rand(g, rows, c)
    w1 = _rand(g, c, hid, std=c ** -0.5, dtype=f32)
    b1 = _rand(g, hid, std=0.02, dtype=f32)
    w2 = _rand(g, hid, out_dim, std=0.5 * hid ** -0.5, dtype=f32)
    b2 = _rand(g, out_dim, std=0.02, dtype=f32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    s = mlp.col_slices(hid)
    mlp.reset_launches()
    with torch.no_grad():
        out = mlp.fused_mlp(x, w1, b1, w2, b2, quant=True)
        again = mlp.fused_mlp(x, w1, b1, w2, b2, quant=True)
        xq, xs = quant.row_codes(x.float())
        ref = mlp.mlp_int8_fc2_plain(
            *mlp.mlp_int8_fc1_plain(xq, xs, q1, b1, s), q2, b2, x,
            residual=False)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES["mlp_int8"] == 2
    assert out.shape == (rows, out_dim)
    assert torch.equal(out, ref) and torch.equal(out, again)


def test_int8_mlp_block_refuses_before_launch(cuda):
    """Row 15 refuses what its pieces do not take before any launch: a
    strip of 128 hidden units, a width that is not a multiple of 128, an
    f32 x."""
    x = torch.zeros(2, 8, 256, dtype=torch.bfloat16, device=cuda)
    one = torch.ones(256, device=cuda)
    mlp.reset_launches()
    for hid, c in ((512, 256), (1024, 160)):  # strips of 128, C % 128
        w1 = torch.zeros(c, hid, device=cuda)
        w2 = torch.zeros(hid, c, device=cuda)
        xc = torch.zeros(2, 8, c, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="strip width"):
            with torch.no_grad():
                mlp.fused_mlp_block_q(xc, one[:1].expand(c), one[:1].expand(c),
                                      w1, torch.zeros(hid, device=cuda), w2,
                                      torch.zeros(c, device=cuda))
    w1, w2 = torch.zeros(256, 1024, device=cuda), torch.zeros(1024, 256,
                                                               device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        with torch.no_grad():
            mlp.fused_mlp_block_q(x.float(), one, one, w1,
                                  torch.zeros(1024, device=cuda), w2, one)
    torch.cuda.synchronize()
    assert sum(mlp.LAUNCHES.values()) == 0


def test_int_mm_is_exact(cuda):
    """torch._int_mm (int8_dense on the card) against the exact f64
    product, in the one layout it is given."""
    g = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randint(-127, 128, (300, 1024), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (2048, 1024), generator=g, device=cuda,
                      dtype=torch.int8)
    exact = torch.matmul(a.double(), w.t().double()).to(torch.int32)
    assert torch.equal(quant.int_matmul(a, w.t()), exact)
    part = torch.matmul(a[:, :512].double(), w[:, 512:].t().double())
    assert torch.equal(quant.int_matmul(a[:, :512], w[:, 512:].t()),
                       part.to(torch.int32))


def test_int8_wrappers_count_launches_and_refuse(cuda):
    """Rows 5, 6, 11, 14 and 15 count one launch a call, rows 5, 6 and 11 at
    head dims 64 and 32 (4 and 8 heads at C = 256)."""
    attn.reset_launches()
    mlp.reset_launches()
    x = torch.zeros(1, 8, 256, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(256, 768, device=cuda)
    wp = torch.zeros(256, 256, device=cuda)
    one, zero = torch.ones(256, device=cuda), torch.zeros(256, device=cuda)
    with torch.no_grad():
        for h in (4, 8):
            attn.fused_qkvproj_attention(x, w, h, quant=True)
            attn.fused_ln_qkvproj_attention(x, one, zero, w, h, quant=True)
            attn.fused_attention_block_q(x, one, zero, w, wp, zero, h)
        w1 = torch.zeros(256, 1024, device=cuda)
        w2 = torch.zeros(1024, 256, device=cuda)
        bb = torch.zeros(1024, device=cuda)
        mlp.fused_mlp(x, w1, bb, w2, bb[:256], quant=True)
        mlp.fused_mlp_block_q(x, bb[:256] + 1, bb[:256], w1, bb, w2, bb[:256])
    torch.cuda.synchronize()
    assert attn.LAUNCHES["qkvproj_attention_int8"] == 2
    assert attn.LAUNCHES["ln_qkvproj_attention_int8"] == 2
    assert attn.LAUNCHES["attention_block_int8"] == 2
    assert sum(attn.LAUNCHES.values()) == 6
    assert mlp.LAUNCHES == {"mlp_int8": 1, "ln_mlp_int8": 1, "mlp_w8": 0,
                            "ln_mlp_w8": 0, "mlp_bf16": 0, "ln_mlp_bf16": 0}
    with pytest.raises(ValueError, match="bfloat16"):
        with torch.no_grad():
            mlp.fused_mlp(x.float(), w1, bb, w2, bb[:256], quant=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        with torch.no_grad():
            mlp.fused_mlp(x, w1, bb, w2[:, :200], bb[:200], quant=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        attn.fused_qkvproj_attention(x, w.requires_grad_(), 4, quant=True)


def test_uvit_int8_auto_routes_through_the_lnfused_kernels(cuda):
    """The int8 view's `auto` on the card: LN-fused route, rows 5 and 15,
    one weight quantization per weight value."""
    cfg = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=256, depth=2,
               num_heads=4, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = UViT(quant=True, **cfg).init_weights(g).eval()
    plain = UViT(attn_impl="xla", param_dtype=torch.float32, **cfg).eval()
    plain.load_state_dict(q.state_dict())
    x = torch.randn(4, 8, 8, 4, generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    attn.reset_launches()
    mlp.reset_launches()
    with torch.no_grad():
        a, _ = q(x, t)
        quant.reset_quantizations()
        a2, _ = q(x, t)
        b, _ = plain(x, t)
    assert quant.QUANTIZATIONS["weights"] == 0
    assert torch.equal(a, a2)
    assert attn.LAUNCHES["ln_qkvproj_attention_int8"] == 6
    assert mlp.LAUNCHES["ln_mlp_int8"] == 6
    assert sum(attn.LAUNCHES.values()) == 6 and mlp.LAUNCHES["mlp_int8"] == 0
    af, bf = a.float(), b.float()
    assert float((af * bf).sum() / (af.norm() * bf.norm())) > 0.99


@pytest.mark.parametrize("rows,c,out", [(1, 1024, 1024), (33, 256, 256),
                                        (500, 512, 768), (12850, 1024, 1024)])
def test_w8_mlp_kernels_match_twins(cuda, rows, c, out):
    g = torch.Generator(device=cuda).manual_seed(rows + 3)
    hid = 4 * c
    x = _rand(g, rows, c)
    w1 = _rand(g, c, hid, std=0.02, dtype=torch.float32)
    b1 = _rand(g, hid, std=0.02, dtype=torch.float32)
    w2 = _rand(g, hid, out, std=0.02, dtype=torch.float32)
    b2 = _rand(g, out, std=0.02, dtype=torch.float32)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    s = mlp.col_slices(hid)
    with torch.no_grad():
        _agree_int8(mlp.fused_mlp(x, w1, b1, w2, b2, quant="w8"),
                    mlp.mlp_w8_plain(x, q1, b1, q2, b2, s), W8_MLP_REL_L2)
        if out == c:
            _agree_int8(mlp.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2,
                                              quant="w8"),
                        mlp.ln_mlp_w8_plain(x, lns, lnb, q1, b1, q2, b2, s,
                                            1e-5), W8_MLP_REL_L2, x)


def _w8_case(g, rows, c, out, dev):
    hid = 4 * c
    w1 = _rand(g, c, hid, std=0.02, dtype=torch.float32)
    w2 = _rand(g, hid, out, std=0.02, dtype=torch.float32)
    return dict(x=_rand(g, rows, c), w1=w1, w2=w2,
                b1=_rand(g, hid, std=0.02, dtype=torch.float32),
                b2=_rand(g, out, std=0.02, dtype=torch.float32),
                lns=1 + _rand(g, c, std=0.1, dtype=torch.float32),
                lnb=_rand(g, c, std=0.1, dtype=torch.float32),
                q1=quant.quantized_weight(w1), q2=quant.quantized_weight(w2))


@pytest.mark.parametrize("c", [256, 512, 768, 1024, 1536])
@pytest.mark.parametrize("rows", [1, 33, 127, 128, 129, 500, 12850])
def test_w8_mlp_kernels_tile_edges_and_repeats(cuda, rows, c):
    """Row 16 (out = C) and row 17 (another output width) against their
    twins at the edges of their GEMMs' tiles (256 and 200 rows), at every
    U-ViT width and at C = 1536 with an output of 1280, which the mma.sync
    row 17 refused; both give the same bits on a repeat (no atomics, one
    order of every sum)."""
    out = {256: 1024, 512: 256, 768: 512, 1024: 768, 1536: 1280}[c]
    g = torch.Generator(device=cuda).manual_seed(7 * rows + c)
    a = _w8_case(g, rows, c, c, cuda)
    s = mlp.col_slices(4 * c)
    with torch.no_grad():
        y = mlp.fused_mlp_block_q(a["x"], a["lns"], a["lnb"], a["w1"],
                                  a["b1"], a["w2"], a["b2"], quant="w8")
        again = mlp.fused_mlp_block_q(a["x"], a["lns"], a["lnb"], a["w1"],
                                      a["b1"], a["w2"], a["b2"], quant="w8")
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    _agree_int8(y, mlp.ln_mlp_w8_plain(a["x"], a["lns"], a["lnb"], a["q1"],
                                       a["b1"], a["q2"], a["b2"], s, 1e-5),
                W8_MLP_REL_L2, a["x"])
    b = _w8_case(g, rows, c, out, cuda)
    with torch.no_grad():
        z, again = (mlp.fused_mlp(b["x"], b["w1"], b["b1"], b["w2"], b["b2"],
                                  quant="w8") for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(z, again)
    _agree_int8(z, mlp.mlp_w8_plain(b["x"], b["q1"], b["b1"], b["q2"],
                                    b["b2"], s), W8_MLP_REL_L2)


def _ln_chain_lanes(x, lns, lnb, eps):
    """The bf16-chain LN2 of row 16's LN pass with its f32 sums in the
    kernel's lane order (``delta._lane_sum``)."""
    xf, c, bf = x.float(), x.shape[-1], torch.bfloat16
    mu = quant.true_div(delta._lane_sum(xf), c)
    var = quant.true_div(delta._lane_sum(xf * xf), c) - mu * mu
    inv = torch.rsqrt(var + eps).to(bf)
    return (x - mu.to(bf)) * inv * lns.to(bf) + lnb.to(bf)


@pytest.mark.parametrize("rows,c", [(12850, 1024), (7, 256), (33, 768),
                                    (70, 1280)])
def test_w8_ln_pass_is_bit_exact(cuda, rows, c):
    """The LN pass of rows 16 and 13 equals the bf16-chain twin taken in
    the kernel's lane order bit for bit (C 1280: row 13's widest)."""
    g = torch.Generator(device=cuda).manual_seed(rows + c)
    x = (_rand(g, rows, c).float() * 3 + 0.5).to(torch.bfloat16)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    out = mlp._w8_ln_kernel(x, lns, lnb, 1e-5)
    assert torch.equal(out, _ln_chain_lanes(x, lns, lnb, 1e-5))


@pytest.mark.parametrize("m,c", [(12850, 1024), (129, 256), (1, 512),
                                 (385, 768)])
def test_w8_gemms_match_f32_products(cuda, m, c):
    """Row 16's fc1 and fc2 GEMMs against the f32 product of the same bf16
    operands (the int8 codes are exact in bf16), element by element: fc2
    with unit scales, zero bias and a zero residual within one bf16 step
    plus f32 reordering, as test_qkv_gemm_kernel_matches_f32_product holds
    rows 2-3; fc1 through its GELU epilogue within one bf16 step of the
    output plus GELU's slope (< 1.13) times the scaled reordering bound.
    Two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(m + c)
    hid = 4 * c
    a = _rand(g, m, c)
    q1 = quant.quantized_weight(_rand(g, c, hid, std=0.02,
                                      dtype=torch.float32))
    b1 = _rand(g, hid, std=0.5, dtype=torch.float32)
    h = mlp._w8_fc1_kernel(a, q1, b1)
    assert torch.equal(h, mlp._w8_fc1_kernel(a, q1, b1))
    w1 = q1.q.float()
    pre = (a.float() @ w1.t()) * q1.scale + b1
    ref = mlp._gelu_f32(pre)
    top = ref.abs().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    reorder = 2 * c * 2.0 ** -24 * (a.float().abs() @ w1.abs().t())
    err = (h.float() - ref).abs() / (step + 1.13 * reorder * q1.scale
                                     + 1e-6 * pre.abs() + 1e-30)
    assert float(err.max()) <= 1.0
    q2 = quant.QWeight(q=torch.randint(-127, 128, (c, hid), generator=g,
                                       device=cuda, dtype=torch.int8),
                       scale=torch.ones(c, device=cuda))
    zero = torch.zeros(m, c, dtype=torch.bfloat16, device=cuda)
    out = mlp._w8_fc2_kernel(h, q2, torch.zeros(c, device=cuda), zero)
    assert torch.equal(out, mlp._w8_fc2_kernel(h, q2,
                                               torch.zeros(c, device=cuda),
                                               zero))
    assert _bf16_steps(out, h.float() @ q2.q.float().t(), h, q2.q) <= 1.0


def test_w8_wrappers_count_launches_and_refuse(cuda):
    mlp.reset_launches()
    x = torch.zeros(1, 8, 256, dtype=torch.bfloat16, device=cuda)
    w1 = torch.zeros(256, 1024, device=cuda)
    w2 = torch.zeros(1024, 256, device=cuda)
    bb = torch.zeros(1024, device=cuda)
    with torch.no_grad():
        mlp.fused_mlp(x, w1, bb, w2, bb[:256], quant="w8")
        mlp.fused_mlp_block_q(x, bb[:256] + 1, bb[:256], w1, bb, w2, bb[:256],
                              quant="w8")
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == {"mlp_int8": 0, "ln_mlp_int8": 0, "mlp_w8": 1,
                            "ln_mlp_w8": 1, "mlp_bf16": 0, "ln_mlp_bf16": 0}
    with pytest.raises(ValueError, match="bfloat16"):
        with torch.no_grad():
            mlp.fused_mlp(x.float(), w1, bb, w2, bb[:256], quant="w8")
    with pytest.raises(ValueError, match="output width"):
        with torch.no_grad():
            mlp.fused_mlp(x, w1, bb, w2[:, :200], bb[:200], quant="w8")
    with pytest.raises(NotImplementedError, match="inference-only"):
        mlp.fused_mlp(x, w1.requires_grad_(), bb, w2, bb[:256], quant="w8")


def test_uvit_w8_auto_routes_through_the_lnfused_kernels(cuda):
    """The w8 view's `auto` on the card: the bf16 LN + QKV-projection kernel
    (row 3) and the w8 MLP sub-block (row 16), one quantization per weight
    value, and a field close to the bf16 view of the same weights."""
    cfg = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=256, depth=2,
               num_heads=4, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    w8 = UViT(quant="w8", **cfg).init_weights(g).eval()
    plain = UViT(attn_impl="xla", param_dtype=torch.float32, **cfg).eval()
    plain.load_state_dict(w8.state_dict())
    x = torch.randn(4, 8, 8, 4, generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    attn.reset_launches()
    mlp.reset_launches()
    with torch.no_grad():
        a, _ = w8(x, t)
        quant.reset_quantizations()
        a2, _ = w8(x, t)
        b, _ = plain(x, t)
    assert quant.QUANTIZATIONS["weights"] == 0
    assert torch.equal(a, a2)
    assert attn.LAUNCHES["ln_qkvproj_attention"] == 6
    assert mlp.LAUNCHES == {"mlp_int8": 0, "ln_mlp_int8": 0, "mlp_w8": 0,
                            "ln_mlp_w8": 6, "mlp_bf16": 0, "ln_mlp_bf16": 0}
    assert sum(attn.LAUNCHES.values()) == 6
    af, bf = a.float(), b.float()
    assert float((af * bf).sum() / (af.norm() * bf.norm())) > 0.999


@pytest.mark.parametrize("b,h,l,d", [(50, 8, 1024, 32), (50, 4, 1024, 64),
                                     (50, 8, 600, 32), (1, 1, 1, 32),
                                     (2, 3, 17, 64), (3, 2, 700, 64)])
def test_fwd_kernel_matches_twin(cuda, b, h, l, d):
    """Kernel 7 at chip_smoke.py's phase-3 shapes and ragged edges."""
    g = torch.Generator(device=cuda).manual_seed(l + d)
    q, k, v = (_rand(g, b, h, l, d) for _ in range(3))
    with torch.no_grad():
        _agree(attn.fused_attention(q, k, v),
               attn.attention_plain(q, k, v, d ** -0.5))
        # the dispatcher's routes: auto takes the kernel above L = 512
        _agree(attn.multi_head_attention(q, k, v, impl="pallas"),
               attn.attention_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                               600, 1023, 1024])
def test_fwd_kernel_tile_edges_and_repeats(cuda, l, d):
    """Kernel 7 at the edges of its 128-row query tile and its 256-key score
    tile, within the bf16 forward limits; two calls on the same inputs give
    the same bits (no atomics, one fixed order of every sum)."""
    g = torch.Generator(device=cuda).manual_seed(5 * l + d)
    q, k, v = (_rand(g, 2, 3, l, d) for _ in range(3))
    with torch.no_grad():
        out = attn.fused_attention(q, k, v)
        again = attn.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree(out, attn.attention_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("b,h,d,scale", [(50, 8, 32, None), (50, 4, 64, None),
                                         (50, 8, 32, -0.125)])
@pytest.mark.parametrize("l", [1, 129, 257, 600])
def test_fwd_kernel_many_items_a_block(cuda, b, h, l, d, scale):
    """Kernel 7 with many heads at ragged L, so that each persistent block
    walks several 128-row items: Q's two slots, and the K / V ring running
    on across items and heads, within the bf16 forward limits; two calls
    give the same bits."""
    scale = d ** -0.5 if scale is None else scale
    g = torch.Generator(device=cuda).manual_seed(7 * l + d)
    q, k, v = (_rand(g, b, h, l, d) for _ in range(3))
    with torch.no_grad():
        out = attn._fwd_kernel(q, k, v, scale)
        again = attn._fwd_kernel(q, k, v, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree(out, attn.attention_plain(q, k, v, scale))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("scale", [-0.3, -0.125, 0.0])
def test_fwd_kernel_takes_any_scale(cuda, scale, d):
    """A negative scale takes the row max at the least raw score; a zero
    scale gives uniform probabilities."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (_rand(g, 2, 2, 600, d) for _ in range(3))
    with torch.no_grad():
        out = attn._fwd_kernel(q, k, v, scale)
    _agree(out, attn.attention_plain(q, k, v, scale))


def test_fwd_kernel_counts_launches_and_refuses(cuda):
    attn.reset_launches()
    q = torch.zeros(2, 2, 600, 32, dtype=torch.bfloat16, device=cuda)
    short = q[:, :, :512]
    with torch.no_grad():
        attn.multi_head_attention(q, q, q)               # auto: the kernel
        attn.multi_head_attention(short, short, short)   # auto: plain math
        attn.multi_head_attention(short, short, short, impl="pallas")
        # a strided view is made contiguous first
        attn.fused_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             q, q)
    torch.cuda.synchronize()
    assert attn.LAUNCHES["attention_fwd"] == 3
    assert sum(attn.LAUNCHES.values()) == 3
    with pytest.raises(ValueError, match="attn_impl='xla'"):
        with torch.no_grad():
            attn.fused_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head dim"):
        with torch.no_grad():
            attn.fused_attention(q[..., :16], q[..., :16], q[..., :16])
    # above 1024, auto runs the blocked kernel 9, once, against its twin
    long = torch.randn(1, 1, 1025, 32, generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda).to(torch.bfloat16)
    attn.reset_launches()
    with torch.no_grad():
        out = attn.multi_head_attention(long, long, long)
    torch.cuda.synchronize()
    assert attn.LAUNCHES["flash"] == 1 and sum(attn.LAUNCHES.values()) == 1
    _agree(out, attn.flash_attention_plain(long, long, long, 32 ** -0.5))
    # under autograd the backward runs kernel 8, once per call
    attn.reset_launches()
    qg = q.clone().requires_grad_()
    attn.fused_attention(qg, q, q).float().sum().backward()
    torch.cuda.synchronize()
    assert attn.LAUNCHES["attention_fwd"] == 1
    assert attn.LAUNCHES["fused_attention_bwd"] == 1
    assert qg.grad.shape == q.shape


def test_unet_auto_routes_through_the_fwd_kernel(cuda):
    """A small bf16 UNet at 32 x 32 latents with attention at ds 1: its
    three self-attentions at L = 1024 launch kernel 7 under auto."""
    cfg = dict(image_size=32, model_channels=64, channel_mult=(1, 2),
               num_res_blocks=1, attention_resolutions=(1,),
               num_head_channels=32, context_dim=64, dtype=torch.bfloat16,
               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    fused = UNet(**cfg).init_weights(g, zero_init_std=ZERO_INIT_STD).eval()
    plain = UNet(attn_impl="xla", **cfg).eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(4, 32, 32, 4, generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    attn.reset_launches()
    with torch.no_grad():
        a, _ = fused(x, t)
        b, _ = plain(x, t)
    assert attn.LAUNCHES["attention_fwd"] == 3
    assert sum(attn.LAUNCHES.values()) == 3
    af, bf = a.float(), b.float()
    assert float((af * bf).sum() / (af.norm() * bf.norm())) > 0.999


@pytest.mark.parametrize("b,h,l,d", [(50, 8, 4096, 32), (4, 16, 1025, 64),
                                     (8, 8, 1300, 32), (1, 1, 1, 32),
                                     (2, 3, 257, 64), (1, 2, 2049, 32)])
def test_flash_kernel_matches_twin(cuda, b, h, l, d):
    """Kernel 9 at chip_smoke.py's phase-3 shapes and ragged edges (a
    partial last key block, a single key, one key past a block)."""
    g = torch.Generator(device=cuda).manual_seed(l + d)
    q, k, v = (_rand(g, b, h, l, d) for _ in range(3))
    attn.reset_launches()
    with torch.no_grad():
        out = attn.flash_attention_blocked(q, k, v)
    torch.cuda.synchronize()
    assert attn.LAUNCHES["flash"] == 1
    _agree(out, attn.flash_attention_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [1, 127, 129, 4097])
def test_flash_kernel_tile_edges_and_repeats(cuda, l, d):
    """Kernel 9 at the ragged edges of its 128-row query tile and its
    256-key block (one row, one short of a tile, one past, one key past 16
    blocks), within the bf16 forward limits; two calls on the same inputs
    give the same bits (no atomics, one fixed order of every sum)."""
    g = torch.Generator(device=cuda).manual_seed(3 * l + d)
    q, k, v = (_rand(g, 2, 2, l, d) for _ in range(3))
    with torch.no_grad():
        out = attn.flash_attention_blocked(q, k, v)
        again = attn.flash_attention_blocked(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree(out, attn.flash_attention_plain(q, k, v, d ** -0.5))


def test_flash_kernel_counts_launches_and_refuses(cuda):
    """Kernel 9 takes bf16 at head dims 32 and 64 only, and refuses a call
    that needs a gradient (the JAX kernel has no VJP); pallas and auto
    send L > 1024 to it."""
    q = torch.zeros(1, 2, 1100, 32, dtype=torch.bfloat16, device=cuda)
    attn.reset_launches()
    with torch.no_grad():
        attn.multi_head_attention(q, q, q)
        attn.multi_head_attention(q, q, q, impl="pallas")
        attn.multi_head_attention(q, q, q, impl="pallas_block")
    torch.cuda.synchronize()
    assert attn.LAUNCHES["flash"] == 3 and sum(attn.LAUNCHES.values()) == 3
    with pytest.raises(ValueError, match="attn_impl='xla'"):
        with torch.no_grad():
            attn.flash_attention_blocked(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head dim"):
        with torch.no_grad():
            attn.flash_attention_blocked(q[..., :16], q[..., :16],
                                         q[..., :16])
    with pytest.raises(ValueError, match="no backward"):
        attn.multi_head_attention(q.clone().requires_grad_(), q, q)
    assert attn.LAUNCHES["flash"] == 3


def test_unet_auto_routes_through_the_flash_kernel(cuda):
    """A small bf16 UNet at 36 x 36 latents with attention at ds 1 and 2:
    its three self-attentions at L = 1296 launch kernel 9 under auto, the
    two at L = 324 run plain math; a u-space edit keeps the route."""
    from uspace_tpu_torch.editing.specs import USpaceEdit

    cfg = dict(image_size=36, model_channels=64, channel_mult=(1, 2),
               num_res_blocks=1, attention_resolutions=(1, 2),
               num_head_channels=32, context_dim=64, dtype=torch.bfloat16,
               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    fused = UNet(**cfg).init_weights(g, zero_init_std=ZERO_INIT_STD).eval()
    plain = UNet(attn_impl="xla", **cfg).eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(4, 36, 36, 4, generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    edit = USpaceEdit(delta_grid=torch.zeros(2, 18, 18, 128, device=cuda),
                      scale=1.0, grid_dt=0.5)
    attn.reset_launches()
    with torch.no_grad():
        a, _ = fused(x, t)
        e, _ = fused(x, t, edit=edit)
        b, _ = plain(x, t)
    assert attn.LAUNCHES["flash"] == 6 and sum(attn.LAUNCHES.values()) == 6
    assert torch.equal(a, e)
    af, bf = a.float(), b.float()
    assert float((af * bf).sum() / (af.norm() * bf.norm())) > 0.999


@pytest.mark.parametrize("b,h,l,d", [(128, 8, 1024, 32), (128, 4, 1024, 64),
                                     (128, 8, 600, 32), (1, 1, 1, 32),
                                     (2, 3, 17, 64), (3, 2, 700, 64)])
def test_fused_bwd_kernel_matches_twin(cuda, b, h, l, d):
    """Kernel 8 at chip_smoke.py's phase-3 shapes and ragged edges: dq, dk
    and dv each within the backward limits (the twin in batch chunks)."""
    g = torch.Generator(device=cuda).manual_seed(l + d + 1)
    q, k, v, do = (_rand(g, b, h, l, d) for _ in range(4))
    out = attn.fused_attention_bwd(q, k, v, do)
    parts = [attn.attention_bwd_plain(*ts, d ** -0.5) for ts in zip(
        *(t.split(16) for t in (q, k, v, do)))]
    for o, r in zip(out, (torch.cat(p) for p in zip(*parts))):
        if not r.any():  # L = 1: one key, so dS and with it dq, dk are 0
            assert not o.any()
            continue
        _agree(o, r, BWD_MAX_ABS, BWD_REL_L2)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [127, 129, 1023])
def test_fused_bwd_kernel_tile_edges_and_repeats(cuda, l, d):
    """Kernel 8 at the ragged edges of its 128-row blocks and 64-row tiles
    (one short of a tile, one past, one short of the longest L): dq, dk and
    dv within the backward limits, and two calls on the same inputs give
    the same bits (no atomics, one fixed order of every sum)."""
    g = torch.Generator(device=cuda).manual_seed(5 * l + d)
    q, k, v, do = (_rand(g, 4, 2, l, d) for _ in range(4))
    out = attn.fused_attention_bwd(q, k, v, do)
    again = attn.fused_attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    ref = attn.attention_bwd_plain(q, k, v, do, d ** -0.5)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)
        _agree(o, r, BWD_MAX_ABS, BWD_REL_L2)


def test_fused_bwd_kernel_refuses(cuda):
    q = torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="attn_impl='xla'"):
        attn.fused_attention_bwd(q.float(), q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="do must be"):
        attn.fused_attention_bwd(q, q, q, q.float())
    with pytest.raises(ValueError, match="is on"):
        attn.fused_attention_bwd(q, q, q.cpu(), q)
    with pytest.raises(ValueError, match="head dim"):
        attn.fused_attention_bwd(*(q[..., :16],) * 4)


def test_unet_kernel_gradients_match_plain(cuda):
    """A small UNet at 32 x 32 latents with attention at ds 1 (three
    self-attentions at L = 1024), f32 masters, bf16 compute, its output
    convs drawn live: the gradient through kernels 7 and 8 (auto) against
    the plain path's (xla), and the control with kernel 8 zeroed outside."""
    cfg = dict(image_size=32, model_channels=64, channel_mult=(1, 2),
               num_res_blocks=1, attention_resolutions=(1,),
               num_head_channels=32, context_dim=64, dtype=torch.bfloat16,
               param_dtype=torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    models = {impl: UNet(attn_impl=impl, **cfg) for impl in ("xla", "auto")}
    models["xla"].init_weights(g, zero_init_std=ZERO_INIT_STD)
    models["auto"].load_state_dict(models["xla"].state_dict())
    x = torch.randn(4, 32, 32, 4, generator=g, device=cuda)
    t = torch.rand(4, generator=g, device=cuda)
    grads = {}
    attn.reset_launches()
    for impl, m in models.items():
        v, _ = m(x, t)
        grads[impl] = torch.cat([p.flatten() for p in torch.autograd.grad(
            v.float().square().mean(), list(m.parameters()))])
    torch.cuda.synchronize()
    assert attn.LAUNCHES["attention_fwd"] == 3
    assert attn.LAUNCHES["fused_attention_bwd"] == 3
    assert sum(attn.LAUNCHES.values()) == 6
    a, b = grads["auto"], grads["xla"]
    assert float((a * b).sum() / (a.norm() * b.norm())) > 0.999
    assert float((a - b).norm() / b.norm()) < 5e-2


@pytest.mark.parametrize("shape,cout,stride", [((50, 32, 32, 256), 256, 1),
                                               ((50, 32, 32, 256), 256, 2),
                                               ((4, 16, 16, 64), 128, 1)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, shape, cout, stride):
    """int8_conv on the card (im2col + torch._int_mm) against the exact CPU
    product on the same inputs: equal codes, equal f32 outputs to the last
    bit."""
    g = torch.Generator(device=cuda).manual_seed(cout + stride)
    x = _rand(g, *shape)
    w = _rand(g, cout, shape[-1], 3, 3, std=(9 * shape[-1]) ** -0.5,
              dtype=torch.float32)
    b = _rand(g, cout, std=0.1, dtype=torch.float32)
    st = (stride, stride)
    y = quant.int8_conv(x, w, b, st, (1, 1), torch.float32)
    ref = quant.int8_conv(x.cpu(), w.cpu(), b.cpu(), st, (1, 1),
                          torch.float32)
    xq, xs = quant.image_codes(x)
    rq, rs = quant.image_codes(x.cpu())
    assert torch.equal(xq.cpu(), rq) and torch.equal(xs.cpu(), rs)
    assert torch.equal(y.cpu(), ref)


def _block_args(g, b, l, c):
    """x and the sub-block's f32 parameters (JAX layout); x at the scale of
    the update, so that the bf16 residual add keeps the update's bits."""
    f32 = torch.float32
    return (_rand(g, b, l, c, std=0.05), 1 + _rand(g, c, std=0.1, dtype=f32),
            _rand(g, c, std=0.1, dtype=f32),
            _rand(g, c, 3 * c, std=c ** -0.5, dtype=f32),
            _rand(g, c, c, std=c ** -0.5, dtype=f32),
            _rand(g, c, std=0.1, dtype=f32))


def _bf16_step(v):
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def _agree_update(out, ref, x, rel_l2=REL_L2):
    """A sub-block with its bf16 residual add: kernel and twin may round
    the update one bf16 step apart, and the add then rounds again at the
    output's magnitude, so max-abs one bf16 step of the largest update plus
    one of the largest output; rel-L2 of the update out - x."""
    a, b = out.double() - x.double(), ref.double() - x.double()
    assert torch.isfinite(a).all()
    tol = (_bf16_step(float(b.abs().max()))
           + _bf16_step(float(ref.double().abs().max())))
    err = float((out.double() - ref.double()).abs().max())
    assert err <= tol, (err, tol)
    rel = float((a - b).norm() / b.norm())
    assert rel <= rel_l2, rel


@pytest.mark.parametrize("b,l,h", [(2, 17, 4), (3, 257, 16), (2, 334, 16),
                                   (1, 512, 2), (1, 1, 2)])
def test_attention_block_kernels_match_twins(cuda, b, l, h):
    g = torch.Generator(device=cuda).manual_seed(l + h)
    c = 64 * h
    x, lns, lnb, wqkv, wproj, bproj = args = _block_args(g, b, l, c)
    qws = (quant.quantized_weight(wqkv), quant.quantized_weight(wproj))
    with torch.no_grad():
        _agree_update(attn.fused_attention_block(*args, h),
                      attn.attention_block_plain(*args, h, 0.125, 1e-5), x)
        _agree_update(attn.fused_attention_block_q(*args, h),
                      attn.attention_block_int8_plain(x, lns, lnb, *qws,
                                                      bproj, h, 0.125, 1e-5),
                      x, INT8_ATTN_REL_L2)


def test_attention_block_counts_launches_and_refuses(cuda):
    attn.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(3)
    args = _block_args(g, 1, 8, 256)
    with torch.no_grad():
        attn.fused_attention_block(*args, 4)
        attn.fused_attention_block_q(*args, 4)
    leaves = [t.detach().requires_grad_() for t in args]
    attn.fused_attention_block(*leaves, 4).float().sum().backward()
    torch.cuda.synchronize()
    assert attn.LAUNCHES["attention_block"] == 2  # the backward recomputes
    assert attn.LAUNCHES["attention_block_int8"] == 1
    assert sum(attn.LAUNCHES.values()) == 3
    assert all(torch.isfinite(t.grad).all() for t in leaves)
    with pytest.raises(NotImplementedError, match="inference-only"):
        attn.fused_attention_block_q(*leaves, 4)
    with pytest.raises(ValueError, match="multiple of 128"):
        with torch.no_grad():
            attn.fused_attention_block(*_block_args(g, 1, 8, 64), 1)
    with pytest.raises(ValueError, match="bfloat16"):
        with torch.no_grad():
            attn.fused_attention_block(args[0].float(), *args[1:], 4)


@pytest.mark.parametrize("rows,c,out", [(1, 1024, 1024), (33, 256, 256),
                                        (500, 512, 768), (12850, 1024, 1024),
                                        (70, 1280, 1024)])
def test_bf16_mlp_kernels_match_twins(cuda, rows, c, out):
    g = torch.Generator(device=cuda).manual_seed(rows + 5)
    hid = 4 * c
    x = _rand(g, rows, c)
    w1 = _rand(g, c, hid, std=0.02)
    b1 = _rand(g, hid, std=0.02, dtype=torch.float32)
    w2 = _rand(g, hid, out, std=0.02)
    b2 = _rand(g, out, std=0.02, dtype=torch.float32)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    s = mlp.col_slices(hid)
    with torch.no_grad():
        _agree_int8(mlp.fused_mlp(x, w1, b1, w2, b2),
                    mlp.mlp_bf16_plain(x, w1, b1, w2, b2, s), REL_L2)
        if out == c:
            _agree_update(mlp.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2,
                                                quant=False),
                          mlp.ln_mlp_bf16_plain(x, lns, lnb, w1, b1, w2, b2,
                                                s, 1e-5), x)


def test_bf16_mlp_wrappers_count_launches_and_refuse(cuda):
    mlp.reset_launches()
    x = torch.zeros(1, 8, 256, dtype=torch.bfloat16, device=cuda)
    w1 = torch.zeros(256, 1024, dtype=torch.bfloat16, device=cuda)
    w2 = torch.zeros(1024, 256, dtype=torch.bfloat16, device=cuda)
    bb = torch.zeros(1024, device=cuda)
    with torch.no_grad():
        mlp.fused_mlp(x, w1, bb, w2, bb[:256])
        mlp.fused_mlp_block_q(x, bb[:256] + 1, bb[:256], w1, bb, w2, bb[:256],
                              quant=False)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == {"mlp_int8": 0, "ln_mlp_int8": 0, "mlp_w8": 0,
                            "ln_mlp_w8": 0, "mlp_bf16": 1, "ln_mlp_bf16": 1}
    with pytest.raises(ValueError, match="bfloat16"):
        with torch.no_grad():
            mlp.fused_mlp(x.float(), w1, bb, w2, bb[:256])
    with pytest.raises(ValueError, match="output width"):
        with torch.no_grad():
            mlp.fused_mlp(x, w1, bb, w2[:, :200], bb[:200])
    with pytest.raises(NotImplementedError, match="inference-only"):
        mlp.fused_mlp(x, w1.requires_grad_(), bb, w2, bb[:256])
    with pytest.raises(NotImplementedError, match="inference-only"):
        mlp.fused_mlp_block_q(x, bb[:256] + 1, bb[:256], w1, bb, w2,
                              bb[:256], quant=False)


FC2_TILE_ROWS = 208  # fc2's tile of rows (csrc/mlp_bf16.cu FC2_ROWS)


@pytest.mark.parametrize("m,c", [(12850, 1024), (1, 512), (63, 256),
                                 (129, 768), (FC2_TILE_ROWS - 1, 256),
                                 (FC2_TILE_ROWS, 256),
                                 (FC2_TILE_ROWS + 1, 256)])
def test_bf16_gemms_match_f32_products(cuda, m, c):
    """Rows 12 and 13's fc1 and fc2 GEMMs against the f32 product of the
    same bf16 operands, element by element: fc1 through its GELU epilogue
    within one bf16 step of the output plus GELU's slope (< 1.13) times the
    reordering bound; fc2 with a zero bias within one bf16 step plus f32
    reordering, and its sub-block epilogue with a zero residual giving the
    same bits. Two calls of each give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(m + c + 2)
    hid = 4 * c
    a = _rand(g, m, c)
    w1 = _rand(g, hid, c, std=0.02)  # torch-layout rows
    b1 = _rand(g, hid, std=0.5, dtype=torch.float32)
    h = mlp._bf16_fc1_kernel(a, w1, b1)
    assert torch.equal(h, mlp._bf16_fc1_kernel(a, w1, b1))
    pre = a.float() @ w1.float().t() + b1
    ref = mlp._gelu_f32(pre)
    top = ref.abs().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    reorder = 2 * c * 2.0 ** -24 * (a.float().abs() @ w1.float().abs().t())
    err = (h.float() - ref).abs() / (step + 1.13 * reorder + 1e-6 * pre.abs()
                                     + 1e-30)
    assert float(err.max()) <= 1.0
    w2 = _rand(g, c, hid, std=0.02)
    zb = torch.zeros(c, device=cuda)
    out = mlp._bf16_fc2_kernel(h, w2, zb)
    assert torch.equal(out, mlp._bf16_fc2_kernel(h, w2, zb))
    assert _bf16_steps(out, h.float() @ w2.float().t(), h, w2) <= 1.0
    zero = torch.zeros(m, c, dtype=torch.bfloat16, device=cuda)
    assert torch.equal(mlp._bf16_fc2_kernel(h, w2, zb, zero), out)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_bf16_fc1_rounds_gelu_as_the_twin(cuda, scale):
    """fc1's GELU epilogue rounds every value as the twin's f32 sequence
    (``_gelu_f32``, then bf16) does, bit for bit, over 52.6 M
    pre-activations that every order of the f32 sum gives exactly (one
    nonzero product per output, then the f32 bias)."""
    g = torch.Generator(device=cuda).manual_seed(int(scale) + 11)
    m, c, hid = 12850, 64, 4096
    bf = torch.bfloat16
    a = torch.zeros(m, c, dtype=bf, device=cuda)
    a[:, 0] = ((torch.rand(m, generator=g, device=cuda) * 2 - 1)
               * scale).to(bf)
    w1 = torch.zeros(hid, c, dtype=bf, device=cuda)
    w1[:, 0] = (torch.rand(hid, generator=g, device=cuda) * 2 - 1).to(bf)
    b1 = torch.randn(hid, generator=g, device=cuda) * 0.5
    h = mlp._bf16_fc1_kernel(a, w1, b1)
    pre = a[:, :1].float() * w1[:, 0].float() + b1  # exact product, + b1
    assert torch.equal(h, mlp._gelu_f32(pre).to(bf))


@pytest.mark.parametrize("rows", [1, FC2_TILE_ROWS - 1, FC2_TILE_ROWS,
                                  FC2_TILE_ROWS + 1, 12850])
def test_bf16_mlp_repeats_are_bit_equal(cuda, rows):
    """Rows 12 and 13 give the same bits on a repeat (no split-K, no
    atomics: one order of every sum), one launch counted a call."""
    c = 1024 if rows == 12850 else 256
    g = torch.Generator(device=cuda).manual_seed(rows + 9)
    hid = 4 * c
    x = _rand(g, rows, c)
    w1 = _rand(g, c, hid, std=0.02)
    b1 = _rand(g, hid, std=0.02, dtype=torch.float32)
    w2 = _rand(g, hid, c, std=0.02)
    b2 = _rand(g, c, std=0.02, dtype=torch.float32)
    lns = 1 + _rand(g, c, std=0.1, dtype=torch.float32)
    lnb = _rand(g, c, std=0.1, dtype=torch.float32)
    mlp.reset_launches()
    with torch.no_grad():
        ys = [mlp.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2, quant=False)
              for _ in range(2)]
        zs = [mlp.fused_mlp(x, w1, b1, w2, b2) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(zs[0], zs[1])
    assert mlp.LAUNCHES["ln_mlp_bf16"] == 2 and mlp.LAUNCHES["mlp_bf16"] == 2


@pytest.mark.parametrize("view,counts", [
    (False, dict(attention_block=3)),
    (True, dict(attention_block_int8=3, ln_mlp_int8=3)),
    ("w8", dict(attention_block=3, mlp_w8=3)),
    ("w8a8_mlp", dict(attention_block=3, mlp_int8=3)),
])
def test_uvit_pallas_block_routes_through_the_block_kernels(cuda, view,
                                                             counts):
    """Each view on pallas_block: its kernels once per block and no other,
    the field close to the plain path's."""
    cfg = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=256, depth=2,
               num_heads=4, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    m = UViT(attn_impl="pallas_block", quant=view,
             param_dtype=torch.float32, **cfg).init_weights(g).eval()
    plain = UViT(attn_impl="xla", param_dtype=torch.float32, **cfg).eval()
    plain.load_state_dict(m.state_dict())
    x = torch.randn(4, 8, 8, 4, generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    attn.reset_launches()
    mlp.reset_launches()
    with torch.no_grad():
        a, _ = m(x, t)
        got = {**attn.LAUNCHES, **mlp.LAUNCHES}
        b, _ = plain(x, t)
    want = dict.fromkeys(got, 0)
    want.update(counts)
    assert got == want
    af, bf = a.float(), b.float()
    assert float((af * bf).sum() / (af.norm() * bf.norm())) > 0.999


# ---------------------------------------------------------------------------
# the stage-delta kernels (rows 18 to 25)
# ---------------------------------------------------------------------------


def _agree_codes(out, ref):
    d = (out.int() - ref.int()).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= 5e-3


def _agree_delta(out, ref, base, rel_l2):
    """A delta kernel's part (out - base): max-abs one bf16 step of the
    largest part plus one of the largest output (the output rounds at its
    own magnitude), rel-L2 of the part."""
    a, b = out.double() - base.double(), ref.double() - base.double()
    assert torch.isfinite(a).all()
    tol = (_bf16_step(float(b.abs().max()))
           + _bf16_step(float(ref.double().abs().max())))
    assert float((out.double() - ref.double()).abs().max()) <= tol
    rel = float((a - b).norm() / b.norm())
    assert rel <= rel_l2, rel


def _delta_attn_case(g, b, l, c):
    f32 = torch.float32
    xb = _rand(g, b, l, c)
    x = (xb.float() + _rand(g, b, l, c, std=0.1, dtype=f32)).to(xb.dtype)
    lns, lnb = 1 + _rand(g, c, std=0.1, dtype=f32), _rand(g, c, std=0.1,
                                                          dtype=f32)
    qw = quant.quantized_weight(_rand(g, c, 3 * c, std=c ** -0.5, dtype=f32))
    qp = quant.quantized_weight(_rand(g, c, c, std=c ** -0.5, dtype=f32))
    return xb, x, lns, lnb, qw, qp


@pytest.mark.parametrize("b,l,h", [(2, 17, 4), (3, 257, 16), (2, 334, 16),
                                   (1, 512, 2), (1, 1, 2)])
def test_delta_attention_kernels_match_twins(cuda, b, l, h, monkeypatch):
    g = torch.Generator(device=cuda).manual_seed(l + 7 * h)
    c = 64 * h
    xb, x, lns, lnb, qw, qp = _delta_attn_case(g, b, l, c)
    xm_b = _rand(g, b, l, c)
    with torch.no_grad():
        out = delta.base_attn_block(xb, lns, lnb, qw.kn, qw.scale, h, 1e-5)
        ref = delta.base_attn_plain(xb, lns, lnb, qw.kn, qw.scale, h, 1e-5)
        _agree_int8(out[0], ref[0], INT8_ATTN_REL_L2)
        _agree_codes(out[1][:, :l], ref[1][:, :l])
        assert float((out[2] - ref[2])[:, :l].abs().max()) <= 1e-6
        a_b, cq, cs = ref
        args = (x, xb, cq, cs, a_b, xm_b, lns, lnb, qw.kn, qw.scale, qp.kn,
                qp.scale, h, 1e-5)
        kern = delta.delta_attn_block(*args)
        monkeypatch.setattr(delta, "packed_attention_plain",
                            attn.fused_qkv_attention)
        _agree_delta(kern, delta.delta_attn_plain(*args), xm_b,
                     INT8_ATTN_REL_L2)
        # zero delta: the base's own point reproduces xm_b exactly
        a_k, cq_k, cs_k = out
        same = delta.delta_attn_block(xb, xb, cq_k, cs_k, a_k, xm_b, lns,
                                      lnb, qw.kn, qw.scale, qp.kn, qp.scale,
                                      h, 1e-5)
        assert torch.equal(same, xm_b)


@pytest.mark.parametrize("h,d", [(16, 64), (8, 32)])
@pytest.mark.parametrize("l", [17, 257])
@pytest.mark.parametrize("rows", [1, 33, 12850])
def test_delta_attn_gemms_are_bit_exact(cuda, rows, l, h, d):
    """Row 19's code pass and its two wgmma GEMMs alone on the same codes:
    the codes of LN1(x) - LN1(x_b) bit-equal to ``ln_delta_codes_plain``,
    the qkv GEMM on the padded cache (Lp = round_up(L, 32), read at the
    cache row of each row) bit-equal to ``qkv_delta_plain`` and the xm GEMM
    to ``xm_delta_plain``: int32 sums are exact. C = H * D: heads of 64 and
    of 32."""
    g = torch.Generator(device=cuda).manual_seed(rows + l + d)
    f32 = torch.float32
    c = h * d
    b = -(-rows // l)
    lp = delta.round_up(l, delta.SEQ_ALIGN)
    xb = _rand(g, rows, c)
    x = (xb.float() + _rand(g, rows, c, std=0.1, dtype=f32)).to(xb.dtype)
    lns, lnb = 1 + _rand(g, c, std=0.1, dtype=f32), _rand(g, c, std=0.1,
                                                          dtype=f32)
    qw = quant.quantized_weight(_rand(g, c, 3 * c, std=c ** -0.5, dtype=f32))
    qp = quant.quantized_weight(_rand(g, c, c, std=c ** -0.5, dtype=f32))
    qkv_q = torch.randint(-127, 128, (b, lp, 3 * c), generator=g,
                          device=cuda, dtype=torch.int8)
    qkv_s = torch.rand((b, lp, 1), generator=g, device=cuda) * 0.02
    xm_b = _rand(g, rows, c)
    with torch.no_grad():
        codes, sr = delta._ln_delta_codes_kernel(x, xb, lns, lnb, 1e-5)
        ref_q, ref_s = delta.ln_delta_codes_plain(x, xb, lns, lnb, 1e-5)
        qkv = delta._qkv_delta_kernel(codes, sr, qw.q, qw.scale, qkv_q,
                                      qkv_s, l)
        xm = delta._xm_delta_kernel(codes, sr, qp.q, qp.scale, x, xb, xm_b)
    torch.cuda.synchronize()
    assert torch.equal(codes, ref_q) and torch.equal(sr, ref_s.reshape(-1))
    assert torch.equal(qkv, delta.qkv_delta_plain(
        codes, sr[:, None], qw.kn, qw.scale, qkv_q, qkv_s, l))
    assert torch.equal(xm, delta.xm_delta_plain(codes, sr[:, None], qp.kn,
                                                qp.scale, x, xb, xm_b))


@pytest.mark.parametrize("h,d", [(16, 64), (32, 32)])
@pytest.mark.parametrize("rows,l,lp", [(12850, 250, 257), (129, 40, 43),
                                       (1, 1, 1)])
def test_base_attn_passes_are_bit_equal(cuda, rows, l, lp, h, d):
    """Row 18's two passes of the int8 wgmma GEMM alone on the same codes
    (rows m of [., Lp], those with m % Lp < L in the bf16 output): pass A's
    row amax partials bit-equal to ``qkv_amax_plain``, pass B's codes, row
    scales and bf16 buffer to ``qkv_code_plain`` on those partials: int32
    sums are exact and both passes round the product alike."""
    g = torch.Generator(device=cuda).manual_seed(rows + l + d)
    f32 = torch.float32
    c = h * d
    lns, lnb = 1 + _rand(g, c, std=0.1, dtype=f32), _rand(g, c, std=0.1,
                                                          dtype=f32)
    qw = quant.quantized_weight(_rand(g, c, 3 * c, std=c ** -0.5, dtype=f32))
    codes, sr = quant.row_codes(delta.ln_lanes(_rand(g, rows, c), lns, lnb,
                                               1e-5))
    sr = sr.reshape(-1)
    with torch.no_grad():
        part = delta._qkv_amax_kernel(codes, sr, qw.q, qw.scale)
        got = delta._qkv_code_kernel(codes, sr, qw.q, qw.scale, part, l, lp)
    torch.cuda.synchronize()
    ref_part = delta.qkv_amax_plain(codes, sr[:, None], qw.kn, qw.scale)
    assert torch.equal(part, ref_part)
    want = delta.qkv_code_plain(codes, sr[:, None], qw.kn, qw.scale,
                                ref_part, l, lp)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1].reshape(-1))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("b,l,h", [(2, 17, 4), (50, 257, 16), (2, 334, 16),
                                   (1, 512, 2), (1, 1, 2), (3, 257, 32)])
def test_base_attn_cache_is_the_twins(cuda, b, l, h):
    """Row 18 whole: its cache over all Lp rows (the padded rows included)
    bit-equal to the twin's, and ``a`` bit-equal to row 1's kernel on the
    twin's bf16 buffer; a repeat bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(3 * l + h)
    c = 64 * h if h <= 16 else 32 * h
    xb, _, lns, lnb, qw, _ = _delta_attn_case(g, b, l, c)
    with torch.no_grad():
        out = delta.base_attn_block(xb, lns, lnb, qw.kn, qw.scale, h, 1e-5)
        again = delta.base_attn_block(xb, lns, lnb, qw.kn, qw.scale, h, 1e-5)
        _, cq, cs = delta.base_attn_plain(xb, lns, lnb, qw.kn, qw.scale, h,
                                          1e-5)
        a = attn.fused_qkv_attention(
            (cq[:, :l].float() * cs[:, :l]).to(torch.bfloat16), h)
    torch.cuda.synchronize()
    assert torch.equal(out[1], cq) and torch.equal(out[2], cs)
    assert torch.equal(out[0], a)
    assert all(torch.equal(x, y) for x, y in zip(out, again))


def _delta_mlp_case(g, rows, c):
    f32 = torch.float32
    hid = 4 * c
    xb = _rand(g, rows, c)
    x = (xb.float() + _rand(g, rows, c, std=0.1, dtype=f32)).to(xb.dtype)
    lns, lnb = 1 + _rand(g, c, std=0.1, dtype=f32), _rand(g, c, std=0.1,
                                                          dtype=f32)
    q1 = quant.quantized_weight(_rand(g, c, hid, std=0.02, dtype=f32))
    q2 = quant.quantized_weight(_rand(g, hid, c, std=0.02, dtype=f32))
    b1 = _rand(g, hid, std=0.02, dtype=f32)
    b2 = _rand(g, c, std=0.02, dtype=f32)
    return xb, x, lns, lnb, q1, b1, q2, b2


@pytest.mark.parametrize("rows,c", [(1, 1024), (33, 256), (500, 512),
                                    (12850, 1024)])
def test_delta_mlp_kernels_match_twins(cuda, rows, c):
    g = torch.Generator(device=cuda).manual_seed(rows + c)
    xb, x, lns, lnb, q1, b1, q2, b2 = _delta_mlp_case(g, rows, c)
    s = mlp.col_slices(4 * c)
    with torch.no_grad():
        out = delta.base_mlp_block(xb, lns, lnb, q1.kn, q1.scale, b1, q2.kn,
                                   q2.scale, b2, 1e-5, mode="grad")
        ref = delta.base_mlp_grad_plain(xb, lns, lnb, q1.kn, q1.scale, b1,
                                        q2.kn, q2.scale, b2, 1e-5, s)
        _agree_int8(out[0], ref[0], INT8_MLP_REL_L2, xb)
        _agree_codes(out[1], ref[1])
        assert float((out[2] - ref[2]).abs().max()) <= 1e-6
        _agree_int8(out[3], ref[3], INT8_MLP_REL_L2)
        _, gq, gs, m_b = ref
        args = (x, xb, gq, gs, m_b, lns, lnb, q1.kn, q1.scale, q2.kn,
                q2.scale, 1e-5)
        _agree_delta(delta.delta_mlp_block(*args, grad=True),
                     delta.delta_mlp_lin_plain(*args, s),
                     x.float() + m_b.float(), INT8_MLP_REL_L2)
        # zero delta: the base's own point reproduces the base's output
        same = delta.delta_mlp_block(xb, xb, out[1], out[2], out[3], lns,
                                     lnb, q1.kn, q1.scale, q2.kn, q2.scale,
                                     1e-5, grad=True)
        assert torch.equal(same, out[0])


@pytest.mark.parametrize("rows,c", [(1, 1024), (33, 256), (500, 512),
                                    (12850, 1024)])
def test_delta_mlp_e_kernels_match_twins(cuda, rows, c):
    """Rows 20 and 21 on every output, caches included, and rows 25 and 24
    on a stage's x on what they add to the twins' cache; at the base's own
    point row 25 gives the base's output bit for bit and row 24 adds back
    the base's hidden rounding (near it)."""
    g = torch.Generator(device=cuda).manual_seed(3 * rows + c)
    xb, x, lns, lnb, q1, b1, q2, b2 = _delta_mlp_case(g, rows, c)
    s = mlp.col_slices(4 * c)
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    with torch.no_grad():
        out = delta.base_mlp_block(xb, *w, mode="e+g")
        ref = delta.base_mlp_e_plain(xb, *w, s, emit_gelu=True)
        _agree_int8(out[0], ref[0], INT8_MLP_REL_L2, xb)
        _agree_int8(out[3], ref[3], INT8_MLP_REL_L2)
        for i in (1, 4):  # e_q, g_q
            _agree_codes(out[i], ref[i])
        for i in (2, 5, 6):  # e_s, g_s, g_z
            assert float((out[i] - ref[i]).abs().max()) <= 1e-6
        before = dict(delta.LAUNCHES)
        e_only = delta.base_mlp_block(xb, *w, mode="e")
        assert delta.LAUNCHES == dict(before, base_mlp_e=before[
            "base_mlp_e"] + 1)
        assert len(e_only) == 4
        assert all(torch.equal(a, b) for a, b in zip(e_only, out))
        _, e_q, e_s, m_b, g_q, g_s, g_z = ref
        dw = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
        base = x.float() + m_b.float()
        _agree_delta(delta.delta_mlp_block(x, xb, e_q, e_s, m_b, *dw),
                     delta.delta_mlp_exact_plain(x, xb, e_q, e_s, m_b, *dw,
                                                 s),
                     base, INT8_MLP_REL_L2)
        _agree_delta(delta.delta_mlp_block(x, xb, e_q, e_s, m_b, *dw,
                                           gelu_cache=(g_q, g_s, g_z)),
                     delta.delta_mlp_g_plain(x, xb, e_q, e_s, g_q, g_s, g_z,
                                             m_b, *dw, s),
                     base, INT8_MLP_REL_L2)
        same = delta.delta_mlp_block(xb, xb, *out[1:4], *dw)
        assert torch.equal(same, out[0])
        # row 24 at the base's own point adds W2 q8(r), r = gelu(e_b) -
        # deq(g_q) the base's hidden rounding (about 1e-2 of o - x): held to
        # its twin on the kernel's cache, and near the base
        near = delta.delta_mlp_block(xb, xb, *out[1:4], *dw,
                                     gelu_cache=tuple(out[4:]))
        _agree_delta(near, delta.delta_mlp_g_plain(xb, xb, *out[1:3],
                                                   *out[4:], out[3], *dw, s),
                     xb.float() + out[3].float(), INT8_MLP_REL_L2)
        gap = (near.double() - out[0].double()).norm()
        assert float(gap / (out[0].double() - xb.double()).norm()) < 5e-2


@pytest.mark.parametrize("c", [256, 512, 768, 1024])
@pytest.mark.parametrize("rows", [1, 33, 500, 12850])
@pytest.mark.parametrize("mode", ["exact", "grad", "gelu"])
def test_delta_mlp_pieces_shapes_and_repeats(cuda, mode, rows, c):
    """Rows 25, 23 and 24 ("exact", "grad", "gelu": the code pass, the
    mode's fc1 with its dg epilogue on a cluster of hidden / 4 / 256 blocks
    a strip, 1, 2, 3, 4 at these widths, fc2 with the strip fold) against
    their twins on a stage's x on the twin's cache, a repeat bit-equal, and
    at the base's own point: rows 25 and 23 their base row's output (20,
    22) bit for bit, row 24 held to its twin on the kernel's cache and near
    row 21's output (it re-rounds the base's hidden residual)."""
    g = torch.Generator(device=cuda).manual_seed(5 * rows + c)
    xb, x, lns, lnb, q1, b1, q2, b2 = _delta_mlp_case(g, rows, c)
    s = mlp.col_slices(4 * c)
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    dw = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
    with torch.no_grad():
        if mode == "grad":
            base = delta.base_mlp_block(xb, *w, mode="grad")
            _, c_q, c_s, m_b = delta.base_mlp_grad_plain(xb, *w, s)
            kw, gc, at_base = dict(grad=True), (), {}
            plain = delta.delta_mlp_lin_plain
        else:
            gelu = mode == "gelu"
            base = delta.base_mlp_block(xb, *w, mode="e+g" if gelu else "e")
            _, c_q, c_s, m_b, *gc = delta.base_mlp_e_plain(xb, *w, s,
                                                           emit_gelu=gelu)
            kw = dict(gelu_cache=tuple(gc)) if gelu else {}
            at_base = dict(gelu_cache=tuple(base[4:])) if gelu else {}
            plain = (delta.delta_mlp_g_plain if gelu
                     else delta.delta_mlp_exact_plain)
        out = delta.delta_mlp_block(x, xb, c_q, c_s, m_b, *dw, **kw)
        again = delta.delta_mlp_block(x, xb, c_q, c_s, m_b, *dw, **kw)
        _agree_delta(out, plain(x, xb, c_q, c_s, *gc, m_b, *dw, s),
                     x.float() + m_b.float(), INT8_MLP_REL_L2)
        same = delta.delta_mlp_block(xb, xb, *base[1:4], *dw,
                                     **(at_base or kw))
        if mode == "gelu":
            _agree_delta(same, plain(xb, xb, *base[1:3], *base[4:], base[3],
                                     *dw, s),
                         xb.float() + base[3].float(), INT8_MLP_REL_L2)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    if mode == "gelu":
        gap = (same.double() - base[0].double()).norm()
        assert float(gap / (base[0].double() - xb.double()).norm()) < 5e-2
    else:
        assert torch.equal(same, base[0])


@pytest.mark.parametrize("c", [256, 512, 768, 1024])
@pytest.mark.parametrize("rows", [12850, 1, 63, 129])
@pytest.mark.parametrize("mode", ["grad", "e+g"])
def test_base_mlp_pieces_are_bit_equal(cuda, mode, rows, c):
    """Rows 22 ("grad") and 21 ("e+g") at hidden 4C in 4 strips (clusters
    of 1, 2, 3 and 4 blocks a strip), each piece bit-equal to its twin on
    the same inputs: the f32 code pass to ``base_codes_plain``, the mode's
    fc1 (its cache, and the affine codes, scales and zero points of its
    hidden) to ``base_fc1_grad_plain`` / ``base_fc1_eg_plain`` on those
    codes, fc2 (x + m and m) to ``base_fc2_plain`` on fc1's hidden; the
    wrapper bit-equal to its pieces in sequence, to the whole twin and to
    a repeat."""
    g = torch.Generator(device=cuda).manual_seed(7 * rows + c)
    f32 = torch.float32
    hid = 4 * c
    x = _rand(g, rows, c)
    lns = 1 + _rand(g, c, std=0.1, dtype=f32)
    lnb = _rand(g, c, std=0.1, dtype=f32)
    q1 = quant.quantized_weight(_rand(g, c, hid, std=c ** -0.5, dtype=f32))
    q2 = quant.quantized_weight(_rand(g, hid, c, std=0.5 * hid ** -0.5,
                                      dtype=f32))
    b1 = _rand(g, hid, std=0.02, dtype=f32)
    b2 = _rand(g, c, std=0.02, dtype=f32)
    s = mlp.col_slices(hid)
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    with torch.no_grad():
        codes, sr = delta._base_codes_kernel(x, lns, lnb, 1e-5)
        ref_q, ref_s = delta.base_codes_plain(x, lns, lnb, 1e-5)
        fc1 = delta._base_fc1_kernel(codes, sr, q1.q, q1.scale, b1, s, mode)
        twin1 = (delta.base_fc1_grad_plain if mode == "grad"
                 else delta.base_fc1_eg_plain)(codes, sr[:, None], q1.kn,
                                               q1.scale, b1, s)
        hidden = fc1[2:]  # (hq, hsc, hzp) or (g_q, g_s, g_z)
        fc2 = delta._base_fc2_kernel(*hidden, q2.q, q2.scale, b2,
                                     q2.colsums(s), x)
        twin2 = delta.base_fc2_plain(*hidden, q2.kn, q2.scale, b2, x)
        block = delta.base_mlp_block(x, *w, mode=mode)
        again = delta.base_mlp_block(x, *w, mode=mode)
        whole = (delta.base_mlp_grad_plain(x, *w, s) if mode == "grad" else
                 delta.base_mlp_e_plain(x, *w, s, emit_gelu=True))
    torch.cuda.synchronize()
    assert torch.equal(codes, ref_q) and torch.equal(sr, ref_s.reshape(-1))
    for got, want in zip(fc1, twin1):
        assert torch.equal(got, want)
    for got, want in zip(fc2, twin2):
        assert torch.equal(got, want)
    pieces = (fc2[0], *fc1[:2], fc2[1]) + (fc1[2:] if mode == "e+g" else ())
    assert len(block) == len(pieces) == len(whole)
    for b_, p_, w_, a_ in zip(block, pieces, whole, again):
        assert torch.equal(b_, p_) and torch.equal(b_, w_)
        assert torch.equal(b_, a_)


def test_delta_kernels_count_launches_and_refuse(cuda):
    delta.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(4)
    xb, x, lns, lnb, qw, qp = _delta_attn_case(g, 2, 8, 256)
    with torch.no_grad():
        a, cq, cs = delta.base_attn_block(xb, lns, lnb, qw.kn, qw.scale, 4,
                                          1e-5)
        delta.delta_attn_block(x, xb, cq, cs, a, xb, lns, lnb, qw.kn,
                               qw.scale, qp.kn, qp.scale, 4, 1e-5)
    mb, m, ln1, ln2, q1, b1, q2, b2 = _delta_mlp_case(g, 16, 256)
    w = (ln1, ln2, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    dw = (ln1, ln2, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
    with torch.no_grad():
        o, gq, gs, m_b = delta.base_mlp_block(mb, *w, mode="grad")
        delta.delta_mlp_block(m, mb, gq, gs, m_b, *dw, grad=True)
        _, e_q, e_s, m_e = delta.base_mlp_block(mb, *w)
        delta.delta_mlp_block(m, mb, e_q, e_s, m_e, *dw)
        _, e_q, e_s, m_g, *gc = delta.base_mlp_block(mb, *w, mode="e+g")
        delta.delta_mlp_block(m, mb, e_q, e_s, m_g, *dw, gelu_cache=gc)
    torch.cuda.synchronize()
    assert delta.LAUNCHES == {"base_attn_cache": 1, "delta_attn": 1,
                              "base_mlp_grad": 1, "delta_mlp_lin": 1,
                              "base_mlp_e": 1, "base_mlp_eg": 1,
                              "delta_mlp_exact": 1, "delta_mlp_g": 1}
    assert cq.shape == (2, 32, 768) and cs.shape == (2, 32, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        with torch.no_grad():
            delta.base_attn_block(xb.float(), lns, lnb, qw.kn, qw.scale, 4,
                                  1e-5)
    with pytest.raises(ValueError, match="strip width"):
        with torch.no_grad():
            delta.base_mlp_block(mb[:, :128].contiguous(), ln1[:128],
                                 ln2[:128], q1.kn[:128, :512],
                                 q1.scale[:512], b1[:512],
                                 q2.kn[:512, :128], q2.scale[:128],
                                 b2[:128], 1e-5, mode="grad")
    with pytest.raises(ValueError, match="one scale per row and strip"):
        with torch.no_grad():
            delta.delta_mlp_block(m, mb, gq, gs[:, :1].contiguous(), m_b,
                                  ln1, ln2, q1.kn, q1.scale, q2.kn, q2.scale,
                                  1e-5, grad=True)
    with pytest.raises(ValueError, match="g_z must hold one scale per row"):
        with torch.no_grad():
            delta.delta_mlp_block(m, mb, e_q, e_s, m_g, *dw, gelu_cache=(
                gc[0], gc[1], gc[2][:, :1].contiguous()))
    with pytest.raises(ValueError, match="g_q must have shape"):
        with torch.no_grad():
            delta.delta_mlp_block(m, mb, e_q, e_s, m_g, *dw, gelu_cache=(
                gc[0][:, :256].contiguous(), gc[1], gc[2]))


@pytest.mark.parametrize("mode", ["exact", "gelu", "grad"])
def test_uvit_stage_delta_field_routes_through_the_delta_kernels(cuda, mode):
    """A small U-ViT's base and delta evaluations on the card in each hidden
    mode: each of its kernels once per block and no other, a zero delta
    equal to the base bit for bit ("gelu": within 5e-3), the fused field
    close to the unfused one."""
    cfg = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=256, depth=2,
               num_heads=4, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    m = UViT(param_dtype=torch.float32, **cfg).init_weights(g).eval()
    dp = delta_field.prepare_delta_params(m)
    x = torch.randn(4, 8, 8, 4, generator=g, device=cuda)
    t = torch.tensor(0.5)
    delta.reset_launches()
    with torch.no_grad():
        f0, cache = delta_field.anchored_vf_base(m, dp, t, x,
                                                 hidden_mode=mode)
        fd = delta_field.anchored_vf_delta(m, dp, t, x, cache)
        fu, _ = delta_field.anchored_vf_base(m, dp, t, x, fused=False,
                                             hidden_mode=mode)
    base, dmlp = {"exact": ("base_mlp_e", "delta_mlp_exact"),
                  "gelu": ("base_mlp_eg", "delta_mlp_g"),
                  "grad": ("base_mlp_grad", "delta_mlp_lin")}[mode]
    want = dict.fromkeys(delta.LAUNCHES, 0)
    want.update({"base_attn_cache": 3, "delta_attn": 3, base: 3, dmlp: 3})
    assert delta.LAUNCHES == want
    if mode == "gelu":
        assert float((fd - f0).norm() / f0.norm()) < 5e-3
    else:
        assert torch.equal(fd, f0)
    assert float((f0 - fu).norm() / fu.norm()) < 0.03


# ---------------------------------------------------------------------------
# head dim 32 (rows 1-5, 10, 18, 19) and the redesigned rows 17 and 10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,l,h", [(2, 1, 4), (2, 17, 4), (2, 63, 4),
                                   (2, 65, 4), (2, 257, 4), (2, 512, 4),
                                   (3, 257, 32)])
def test_head_dim_32_kernels_match_twins(cuda, b, l, h, monkeypatch):
    """Rows 1-5, 10, 18 and 19 at head dim 32 (4 heads of 32 at the U-ViT
    toys' C = 128; 32 heads at the main path's C = 1024) against their
    twins within the head dim 64 limits; row 4 at each L (1, 65 and 257
    end in a 16-row tail chunk), a repeat bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(32 * l + h)
    f32 = torch.float32
    c = 32 * h
    s = 32 ** -0.5
    x = _rand(g, b, l, c)
    w = _rand(g, c, 3 * c, std=c ** -0.5)
    wf = _rand(g, c, 3 * c, std=c ** -0.5, dtype=f32)
    qkv = _rand(g, b, l, 3 * c)
    lns = 1 + _rand(g, c, std=0.1, dtype=f32)
    lnb = _rand(g, c, std=0.1, dtype=f32)
    _agree(attn.fused_qkv_attention(qkv, h),
           attn.packed_attention_plain(qkv, h, s))
    _agree(attn.fused_qkvproj_attention(x, w, h),
           attn.qkvproj_attention_plain(x, w, h, s))
    with torch.no_grad():
        _agree(attn.fused_ln_qkvproj_attention(x, lns, lnb, w, h),
               attn.ln_qkvproj_attention_plain(x, lns, lnb, w, h, s, 1e-5))
        _agree_int8(attn.fused_ln_qkvproj_attention(x, lns, lnb, wf, h,
                                                    quant=True),
                    attn.ln_qkvproj_attention_int8_plain(
                        x, lns, lnb, quant.quantized_weight(wf), h, s, 1e-5),
                    INT8_ATTN_REL_L2)
    qkv_b = _rand(g, b, l, 3 * c, std=0.64)
    do = _rand(g, b, l, c)
    out = attn.packed_attention_bwd(qkv_b, do, h)
    again = attn.packed_attention_bwd(qkv_b, do, h)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree(out, attn.packed_attention_bwd_plain(qkv_b, do, h, s),
           BWD_MAX_ABS, BWD_REL_L2)
    args = _block_args(g, b, l, c)
    with torch.no_grad():
        _agree_update(attn.fused_attention_block(*args, h),
                      attn.attention_block_plain(*args, h, s, 1e-5), args[0])
    xb, xd, dlns, dlnb, qw, qp = _delta_attn_case(g, b, l, c)
    xm_b = _rand(g, b, l, c)
    with torch.no_grad():
        base = delta.base_attn_block(xb, dlns, dlnb, qw.kn, qw.scale, h, 1e-5)
        ref = delta.base_attn_plain(xb, dlns, dlnb, qw.kn, qw.scale, h, 1e-5)
        _agree_int8(base[0], ref[0], INT8_ATTN_REL_L2)
        _agree_codes(base[1][:, :l], ref[1][:, :l])
        a_b, cq, cs = ref
        dargs = (xd, xb, cq, cs, a_b, xm_b, dlns, dlnb, qw.kn, qw.scale,
                 qp.kn, qp.scale, h, 1e-5)
        kern = delta.delta_attn_block(*dargs)
        monkeypatch.setattr(delta, "packed_attention_plain",
                            attn.fused_qkv_attention)
        _agree_delta(kern, delta.delta_attn_plain(*dargs), xm_b,
                     INT8_ATTN_REL_L2)


def test_head_dims_refused_before_launch(cuda):
    """Rows 1-6, 10 and 11 take head dims 32 and 64 and refuse 16 and 128
    before any launch."""
    bf = torch.bfloat16
    attn.reset_launches()
    x = torch.zeros(1, 8, 256, dtype=bf, device=cuda)
    w = torch.zeros(256, 768, dtype=bf, device=cuda)
    wf = torch.zeros(256, 768, device=cuda)
    wp = torch.zeros(256, 256, device=cuda)
    one, zero = torch.ones(256, device=cuda), torch.zeros(256, device=cuda)
    for h, ok in ((8, True), (4, True), (16, False), (2, False)):  # C = 256
        calls = (lambda: attn.fused_qkvproj_attention(x, w, h),
                 lambda: attn.fused_qkvproj_attention(x, wf, h, quant=True),
                 lambda: attn.fused_attention_block_q(
                     x, one, zero, wf, wp, zero, h))
        with torch.no_grad():
            for call in calls:
                if ok:
                    call()
                    continue
                with pytest.raises(ValueError, match="head dim 32 or 64"):
                    call()
    torch.cuda.synchronize()
    assert attn.LAUNCHES["qkvproj_attention"] == 2
    assert attn.LAUNCHES["qkvproj_attention_int8"] == 2
    assert attn.LAUNCHES["attention_block_int8"] == 2
    assert sum(attn.LAUNCHES.values()) == 6


@pytest.mark.parametrize("b,l,c,h", [(3, 257, 128, 4), (3, 257, 384, 6),
                                     (3, 257, 384, 12), (3, 257, 1024, 16),
                                     (50, 257, 1024, 32)])
def test_attention_block_projection_widths_and_repeats(cuda, b, l, c, h):
    """Row 10 with its projection on mlp_bf16.cu's GEMM at C = 128, 384
    (C / 128 odd: a cluster of one block) and 1024 (a cluster of two), at
    head dims 32 and 64, against its twin; a repeat bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(c + h)
    args = _block_args(g, b, l, c)
    with torch.no_grad():
        out, again = (attn.fused_attention_block(*args, h) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree_update(out, attn.attention_block_plain(*args, h, (c // h) ** -0.5,
                                                  1e-5), args[0])


@pytest.mark.parametrize("m,n,k", [(12850, 1024, 1024), (771, 384, 384),
                                   (33, 128, 128), (12850, 1024, 4096)])
def test_fc2_epilogues_are_bit_exact(cuda, m, n, k):
    """Row 10's projection (mlp_bf16.cu fc2 with x, the bias rounded to
    bf16; N = 384 and 128 on clusters of one block) and row 17's fc2 (the
    w8 GEMM's bias epilogue, no residual) equal their twins' f32 sequences
    bit for bit on integer operands, whose sums every order gives exactly:
    ``x + bf16(acc + bf16(b))`` and ``bf16(acc * s2 + b2)``."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    bf, f32 = torch.bfloat16, torch.float32

    def ints(*shape, top=4):
        return torch.randint(-top, top + 1, shape, generator=g,
                             device=cuda).to(bf)

    a, wr, x = ints(m, k), ints(n, k), _rand(g, m, n)
    bias = _rand(g, n, std=0.5, dtype=f32).to(bf).float()
    acc = a.float() @ wr.float().t()
    out = mlp._bf16_fc2_kernel(a, wr, bias, x)
    assert torch.equal(out, x + (acc + bias).to(bf))
    q2 = quant.QWeight(q=torch.randint(-127, 128, (n, k), generator=g,
                                       device=cuda, dtype=torch.int8),
                       scale=torch.rand(n, generator=g, device=cuda) * 0.01)
    b2 = _rand(g, n, std=0.5, dtype=f32)
    acc8 = a.float() @ q2.q.float().t()
    assert torch.equal(mlp._w8_fc2_kernel(a, q2, b2),
                       (acc8 * q2.scale + b2).to(bf))


def test_t2i_large_row_2_matches_twin(cuda):
    """Row 2 at U-ViT-T2I-large's CFG field: B = 100 (50 prompts doubled),
    L = 334 (1 time + 77 context + 256 image tokens), 16 heads of 64."""
    g = torch.Generator(device=cuda).manual_seed(334)
    b, l, h, c = 100, 334, 16, 1024
    x = _rand(g, b, l, c)
    w = _rand(g, c, 3 * c, std=c ** -0.5)
    with torch.no_grad():
        _agree(attn.fused_qkvproj_attention(x, w, h),
               attn.qkvproj_attention_plain(x, w, h, 0.125))


@pytest.mark.parametrize("l", [6, 13])
def test_context_toy_rows_1_and_4_match_twins(cuda, l):
    """Rows 1, 2 and 4 at the conditional toys' lengths, head dim 32 (4
    heads of 32): L = 6 (time, label, 4 patches) and L = 13 (time, 8
    context tokens, 4 patches) at their training batch 256; a repeat of
    the backward bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(l)
    b, h, c = 256, 4, 128
    s = 32 ** -0.5
    qkv = _rand(g, b, l, 3 * c, std=0.64)
    do = _rand(g, b, l, c)
    x = _rand(g, b, l, c)
    w = _rand(g, c, 3 * c, std=c ** -0.5)
    with torch.no_grad():
        _agree(attn.fused_qkv_attention(qkv, h),
               attn.packed_attention_plain(qkv, h, s))
        _agree(attn.fused_qkvproj_attention(x, w, h),
               attn.qkvproj_attention_plain(x, w, h, s))
    out = attn.packed_attention_bwd(qkv, do, h)
    again = attn.packed_attention_bwd(qkv, do, h)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _agree(out, attn.packed_attention_bwd_plain(qkv, do, h, s),
           BWD_MAX_ABS, BWD_REL_L2)


def test_edited_uvit_t2i_at_multiplier_1_is_the_plain_forward(cuda):
    """A bf16 U-ViT-T2I (L = 1 + 77 + 16) with an AttnEdit of multiplier 1
    on `auto` takes the plain attention in every block: no kernel launch,
    and its forward equals the plain route's (`xla`) bit for bit."""
    from uspace_tpu_torch.editing.specs import AttnEdit, p2p_col_mult
    from uspace_tpu_torch.models import UViTT2I

    kw = dict(img_size=8, embed_dim=128, depth=4, num_heads=2,
              dtype=torch.bfloat16, device=cuda)
    auto = UViTT2I(attn_impl="auto", **kw).init_weights(
        torch.Generator(device=cuda).manual_seed(0)).eval()
    plain = UViTT2I(attn_impl="xla", **kw).eval()
    plain.load_state_dict(auto.state_dict())
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 8, 8, 4), generator=g, device=cuda)
    t = torch.full((4,), 0.4, device=cuda)
    ctx = torch.randn((4, 77, 768), generator=g, device=cuda)
    edit = AttnEdit(p2p_col_mult(4, 94, [[1], [2], [1], [5]], 1.0,
                                 device=cuda))
    attn.reset_launches()
    with torch.no_grad():
        out, _ = auto(x, t, ctx, attn_edit=edit)
        ref, _ = plain(x, t, ctx)
        kern, _ = auto(x, t, ctx)
    torch.cuda.synchronize()
    assert attn.LAUNCHES["qkvproj_attention"] == 1 * 5
    assert sum(attn.LAUNCHES.values()) == 5
    assert torch.equal(out, ref)
    _agree(kern, ref, 5e-2, 1e-2)


def _toy_loop_config(tmp_path, cuda, steps, evals=True):
    """``synthetic_attr_e2e`` (embed 128, 4 heads of 32, L = 17) at batch 64
    for ``steps`` steps, logged every step; with ``evals`` a checkpoint and
    an FID at the last step and a vis grid of 8, the FID on 16 samples of
    the config's Euler-50, decoded by a seeded SD VAE saved in the
    reference's key format, through the random Inception against seeded
    2048-d statistics."""
    import numpy as np

    from uspace_tpu_torch.codecs.vae import AutoencoderKL
    from uspace_tpu_torch.configs import get_config

    cfg = get_config("synthetic_attr_e2e")
    big = 10 * steps
    cfg["train"].update(n_steps=steps, batch_size=64, log_interval=1,
                        save_interval=steps if evals else big,
                        eval_interval=steps if evals else big)
    cfg["vis_num"] = 8
    cfg["sample"].update(n_samples=16, mini_batch_size=16,
                         fid_weights="random")
    if evals:
        vae = AutoencoderKL.from_config(cfg["autoencoder"],
                                        device=cuda).init_weights(
            torch.Generator(device=cuda).manual_seed(0))
        cfg["autoencoder"]["pretrained_path"] = str(tmp_path / "vae.pth")
        torch.save(vae.state_dict(), cfg["autoencoder"]["pretrained_path"])
        acts = np.random.default_rng(0).standard_normal((256, 2048))
        cfg["dataset"]["fid_stat"] = str(tmp_path / "stat.npz")
        np.savez(cfg["dataset"]["fid_stat"], mu=acts.mean(0),
                 sigma=np.cov(acts, rowvar=False))
    return cfg


def test_toy_loop_launches_rows_1_4_and_2(cuda, tmp_path):
    """``train.loop.train`` on the U-ViT toy for 2 steps on the card: rows
    1 and 4 once a block a step in training (no remat: 2 x 7 each), row 2
    once a block an Euler step in the vis grid, the FID and the final FID
    (3 x 7 x 50), no other kernel; finite losses and FIDs."""
    import json
    import math

    from uspace_tpu_torch.ops import delta
    from uspace_tpu_torch.train import loop

    cfg = _toy_loop_config(tmp_path, cuda, 2)
    for m in (attn, mlp, delta):
        m.reset_launches()
    state = loop.train(cfg, str(tmp_path / "run"), device=cuda)
    torch.cuda.synchronize()
    got = {**attn.LAUNCHES, **mlp.LAUNCHES, **delta.LAUNCHES}
    want = dict.fromkeys(got, 0)
    want.update(packed_attention=14, packed_attention_bwd=14,
                qkvproj_attention=3 * 7 * 50)
    assert got == want
    assert int(state.step) == 2
    recs = [json.loads(line) for line in open(tmp_path / "run" /
                                              "metrics.jsonl")]
    assert all(math.isfinite(r["loss"]) for r in recs if "loss" in r)
    fids = [r["fid"] for r in recs if "fid" in r]
    assert len(fids) == 1 and math.isfinite(fids[0])
    assert [r["final_fid"] for r in recs if "final_fid" in r] == fids
    assert (tmp_path / "run" / "vis" / "2.png").exists()


def test_toy_loop_sigterm_and_resume(cuda, tmp_path, monkeypatch):
    """A real SIGTERM from the step-2 metrics record of a 4-step toy run on
    the card: one checkpoint, a clean stop at 2; the resumed run ends where
    an uninterrupted run ends, params and EMA bit for bit (the train
    kernels and the toy's other work are deterministic)."""
    import signal

    from uspace_tpu_torch.train import loop

    def cfg():
        return _toy_loop_config(tmp_path, cuda, 4, evals=False)

    ctrl = loop.train(cfg(), str(tmp_path / "ctrl"), device=cuda)
    real = loop.MetricsWriter

    class Interrupting(real):
        def write(self, step, metrics):
            super().write(step, metrics)
            if step == 2 and "loss" in metrics:
                signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(loop, "MetricsWriter", Interrupting)
    stopped = loop.train(cfg(), str(tmp_path / "int"), device=cuda)
    assert int(stopped.step) == 2
    monkeypatch.setattr(loop, "MetricsWriter", real)
    resumed = loop.train(cfg(), str(tmp_path / "int"), device=cuda)
    assert int(resumed.step) == 4
    for a, b in ((ctrl.params, resumed.params),
                 (ctrl.ema_params, resumed.ema_params),
                 (ctrl.opt_state.mu, resumed.opt_state.mu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(ctrl.rng.get_state(), resumed.rng.get_state())


def test_inception_featurizer_on_the_card_matches_the_cpu(cuda):
    """The random featurizer's pool3 features of seeded images at 256 px
    (a downscale to 299) on the card against its CPU run at the same
    weights, both exact f32: rel-L2 1e-5."""
    import numpy as np

    from uspace_tpu_torch.evals.fid import InceptionFeaturizer

    imgs = np.random.default_rng(0).random((4, 256, 256, 3)).astype(
        np.float32)
    gpu = InceptionFeaturizer("random", device=cuda)(imgs, batch_size=4)
    cpu = InceptionFeaturizer("random", device="cpu")(imgs, batch_size=4)
    assert gpu.shape == (4, 2048)
    rel = np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu)
    assert rel < 1e-5, rel


TINY_VAE = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(), in_channels=3, resolution=32,
                z_channels=4, double_z=True)


def _tiny_vae(device):
    from uspace_tpu_torch.codecs.vae import AutoencoderKL

    return AutoencoderKL(TINY_VAE, device=device).init_weights(
        torch.Generator(device=device).manual_seed(0)).eval()


def test_tiny_vae_encoder_on_the_card_matches_the_cpu(cuda):
    """``data/extraction.make_vae_encoder`` on the card against the same
    weights on the CPU, both exact f32 (TF32 off inside the encoder):
    chip_smoke.py's VAE limits, rel-L2 1e-4."""
    import numpy as np

    from uspace_tpu_torch.data import extraction

    imgs = np.random.default_rng(1).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    vae = _tiny_vae(cuda)
    cpu = _tiny_vae("cpu")
    cpu.load_state_dict(vae.state_dict())
    got = extraction.make_vae_encoder(vae)(imgs)
    want = extraction.make_vae_encoder(cpu)(imgs)
    assert got.shape == (4, 16, 16, 8) and got.dtype == np.float32
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel


def test_extract_features_npy_round_trip_on_the_card(cuda, tmp_path):
    """``extract_features_npy`` with the encoder on the card (the ``cond``
    layout, flips added), read back by ``NpyFeatureDataset`` and the
    registry: every moment and attribute bit-equal to what the encoder
    returned."""
    import numpy as np

    from uspace_tpu_torch.data import extraction
    from uspace_tpu_torch.data.datasets import NpyFeatureDataset, get_dataset

    r = np.random.default_rng(2)
    imgs = r.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    attrs = r.integers(0, 2, (5, 40))
    enc = extraction.make_vae_encoder(_tiny_vae(cuda))
    out = []

    def kept(batch):
        out.append(enc(batch))
        return out[-1]

    data = [{"image": imgs[i], "attr": attrs[i]} for i in range(5)]
    n = extraction.extract_features_npy(data, kept, str(tmp_path), 2,
                                        flip=True)
    assert n == 10
    # batches of 2: each batch encoded as is, then flipped
    moments = {}
    for j, start in enumerate(range(0, 5, 2)):
        for k in range(len(out[2 * j])):
            moments[start + k] = out[2 * j][k]
            moments[5 + start + k] = out[2 * j + 1][k]
    ds = NpyFeatureDataset(str(tmp_path), fmt="cond")
    factory = get_dataset("celebamask256_features_cond", path=str(tmp_path),
                          num=10)
    for i in range(10):
        for item in (ds[i], factory.train[i]):
            assert np.array_equal(item["x"], moments[i])
            assert np.array_equal(item["attr"], attrs[i % 5])
