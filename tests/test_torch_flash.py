"""Row 9 of the kernel table, ``_flash_kernel``: the port's twin, its
dispatcher route and the SD-UNet that reaches it, held to the JAX package.

The JAX side runs ``flash_attention_blocked`` in interpret mode on the CPU;
the port's wrapper takes its plain twin (``flash_attention_plain``) for CPU
tensors. Inputs come from numpy seeds. Tolerances: f32 1e-5 (the same
recurrence summed in another order); bf16 one bf16 step of the largest
output (kernel and twin round p against the same 256-key running max, so
only a sum order can move a rounding); the toy UNet f32 1e-4 of its
output's scale.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.codecs.convert import unet_torch_to_flax
from uspace_tpu.models.unet import UNet as JaxUNet
from uspace_tpu.ops import attention as jattn
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import load_unet_from_jax
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.models.unet import ZERO_INIT_STD, UNet
from uspace_tpu_torch.ops import attention as tattn

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                      torch.bfloat16)}


def _qkv(shape, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tol(dt, ref):
    if dt == "f32":
        return 1e-5
    top = float(np.abs(ref).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7)  # one bf16 step


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape,block", [((1, 2, 300, 64), 128),
                                         ((1, 2, 1100, 32), 256)])
def test_flash_twin_matches_jax(shape, block, dt):
    """The twin against the interpreted kernel: 128-key blocks as
    tests/test_models.py runs it, and the default 256 over a partial last
    block."""
    jd, td = DTYPES[dt]
    q, k, v = _qkv(shape)
    scale = shape[-1] ** -0.5
    ref = jattn.flash_attention_blocked(
        *(jnp.asarray(a, jd) for a in (q, k, v)), scale, block_q=block,
        block_k=block, interpret=True)
    out = tattn.flash_attention_plain(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), scale,
        block_k=block)
    assert out.dtype == td and out.shape == shape
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=0, atol=_tol(dt, r))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dispatcher_sends_long_pallas_calls_to_row9(dt, monkeypatch):
    """impl="pallas" at L = 1025 runs row 9 in both packages (its twin
    here); "auto" on the CPU is plain math in both."""
    jd, td = DTYPES[dt]
    q, k, v = _qkv((1, 2, 1025, 32), seed=1)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    calls = []
    real = tattn.flash_attention_blocked
    monkeypatch.setattr(tattn, "flash_attention_blocked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ref = jattn.multi_head_attention(jq, jk, jv, impl="pallas",
                                     interpret=True)
    out = tattn.multi_head_attention(tq, tk, tv, impl="pallas")
    assert calls == [1]
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=0, atol=_tol(dt, r))
    ref = jattn.multi_head_attention(jq, jk, jv)
    out = tattn.multi_head_attention(tq, tk, tv)
    assert calls == [1]
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=0, atol=_tol(dt, r))


def test_row9_refuses_a_gradient():
    """flash_attention_blocked defines no VJP in the JAX package: a call
    that needs a gradient raises ValueError instead of taking another
    route; without autograd, or on impl="xla", it runs."""
    q = torch.from_numpy(_qkv((1, 1, 1100, 32))[0]).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        tattn.multi_head_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="no backward"):
        tattn.flash_attention_blocked(q, q, q)
    with torch.no_grad():
        assert tattn.flash_attention_blocked(q, q, q).shape == q.shape
    tattn.multi_head_attention(q, q, q, impl="xla").sum().backward()
    assert torch.isfinite(q.grad).all()


# the toy SD-UNet at 36 x 36 latents: its ds-1 level runs L = 1296 (row 9
# on "pallas"), its ds-2 level L = 324 (row 7)
TOY = dict(image_size=36, in_channels=4, out_channels=4, model_channels=32,
           num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
           num_head_channels=32, use_spatial_transformer=True,
           transformer_depth=1, context_dim=24)


def test_toy_unet_reaches_row9_and_matches_jax(monkeypatch):
    """The toy UNet with attn_impl="pallas": JAX's interpreted kernels
    against the port's twins on one set of weights (a seeded port init,
    its output convs drawn live, carried to JAX by the JAX package's
    ``unet_torch_to_flax``); three self-attentions a call take row 9."""
    m = UNet(**TOY, attn_impl="pallas", device="cpu")
    m.init_weights(torch.Generator().manual_seed(3),
                   zero_init_std=ZERO_INIT_STD)
    params = {"params": unet_torch_to_flax(m.state_dict())}
    load_unet_from_jax(m, params).eval()
    r = np.random.default_rng(4)
    x = r.standard_normal((1, 36, 36, 4)).astype(np.float32)
    t = np.array([0.3], np.float32)
    ref, _ = jax.jit(JaxUNet(**TOY, attn_impl="pallas").apply)(
        params, jnp.asarray(x), jnp.asarray(t))
    calls = []
    real = tattn.flash_attention_blocked
    monkeypatch.setattr(tattn, "flash_attention_blocked",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        real(*a, **kw))
    with torch.no_grad():
        out, _ = m(torch.from_numpy(x), torch.from_numpy(t))
    assert calls == [(1, 1, 1296, 32)] * 3
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_unet_large_512_is_the_jax_config_with_two_overrides():
    """unet_large_512 is lfm_cm256_unet_large with nnet.image_size = 64 and
    z_shape = (4, 64, 64); its dissection solve is Euler at 0.02 on the
    mid tap."""
    from uspace_tpu.configs import lfm_cm256_unet_large

    jcfg = lfm_cm256_unet_large.get_config()
    cfg = get_config("unet_large_512")
    assert cfg["z_shape"] == (4, 64, 64)
    want = dict(jcfg.nnet, image_size=64)
    got = dict(cfg["nnet"])
    for k in want:
        v = want[k]
        assert (tuple(v) if isinstance(v, list) else v) == got[k], k
    base = get_config("unet_large")
    assert {k: v for k, v in got.items() if k != "image_size"} == \
        {k: v for k, v in base["nnet"].items() if k != "image_size"}
    d = cfg["dissection"]
    assert d["edit_loc"] == "mid" and d["solver_kwargs"] == dict(
        solver="fixed", solver_fix="euler", solver_fix_step=0.02)
    assert get_config("uvit_large")["dissection"] == d


def test_sample_lfm_decodes_in_chunks(tmp_path):
    """--decode_batch splits the VAE decode; the pixels are those of one
    decode over the batch, to one uint8 level (a conv may sum in another
    order at another batch size)."""
    cfg = get_config("synthetic_unet")
    cfg["z_shape"], cfg["nnet"]["image_size"] = (4, 8, 8), 8
    paths = sample_lfm.run(config=cfg, n_samples=2, batch=2, steps=1,
                           device="cpu", decode=True, decode_batch=1,
                           out=str(tmp_path))
    lat, px = np.load(paths[0]), np.load(paths[1])
    assert px.shape == (2, 64, 64, 3) and px.dtype == np.uint8
    vae = sample_lfm.build_vae(cfg, "cpu")
    with torch.no_grad():
        whole = sample_lfm.to_uint8(vae.decode(torch.from_numpy(lat)))
    assert np.abs(px.astype(int) - whole.astype(int)).max() <= 1
