"""uspace_tpu_torch SD-UNet held to the JAX UNet (uspace_tpu/models/unet.py).

The toy UNet of tests/test_unet.py with its zero-initialised tensors drawn
live (normal x 0.05, as there), one Flax param tree given to JAX and,
through ``load_unet_from_jax`` (strict=True), to the port; inputs from
numpy seeds. The JAX side
runs attn_impl "pallas" on its interpreted _fwd_kernel; the port's wrapper
takes kernel 7's twin on the CPU. Tolerances: f32 1e-4 (the same arithmetic
summed in another order through some 30 layers); bf16 2e-2 of the output's
scale, max-abs and rel-L2: JAX on the CPU keeps bf16 chains in f32, and
both packages' bf16 fields sit about 1.2% (rel-L2) from the f32 field, a
few bf16 steps of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.codecs.convert import unet_torch_to_flax
from uspace_tpu.core import flow as jflow
from uspace_tpu.models.unet import UNet as JaxUNet
from uspace_tpu_torch.codecs.convert import load_unet_from_jax
from uspace_tpu_torch.core import flow as tflow
from uspace_tpu_torch.editing.specs import USpaceEdit
from uspace_tpu_torch.models import get_nnet
from uspace_tpu_torch.models.layers import group_norm
from uspace_tpu_torch.models.unet import (
    ZERO_INIT_STD,
    UNet,
    upsample_nearest2x,
)
from uspace_tpu_torch.ops import attention as tattn

TINY = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=16, use_spatial_transformer=True,
            transformer_depth=1, context_dim=24)
VARIANTS = {
    "context": {},
    "uncond": {},
    "classes": dict(num_classes=5, use_scale_shift_norm=True),
    "legacy": dict(use_spatial_transformer=False),
}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
_PARAMS = {}


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(x=r.standard_normal((2, 16, 16, 4)).astype(np.float32),
                t=np.array([0.3, 0.8], np.float32),
                ctx=r.standard_normal((2, 7, 24)).astype(np.float32),
                y=np.array([1, 4], np.int32))


def _params(variant):
    """Flax params of the variant (cached): a seeded port UNet, its
    zero-init tensors drawn live, through the JAX package's
    ``unet_torch_to_flax`` (a JAX init would cost a compile per
    variant)."""
    if variant not in _PARAMS:
        m = UNet(**dict(TINY, **VARIANTS[variant]), device="cpu")
        m.init_weights(torch.Generator().manual_seed(len(_PARAMS)),
                       zero_init_std=ZERO_INIT_STD)
        _PARAMS[variant] = {"params": unet_torch_to_flax(m.state_dict())}
    return _PARAMS[variant]


def _pair(variant, dt="f32", impl="xla"):
    jd, td, _ = DTYPES[dt]
    cfg = dict(TINY, **VARIANTS[variant])
    jm = JaxUNet(**cfg, dtype=jd, attn_impl=impl)
    tm = load_unet_from_jax(UNet(**cfg, dtype=td, attn_impl=impl,
                                 device="cpu"), _params(variant)).eval()
    return jm, tm


def _args(variant, a, torch_side):
    conv = torch.from_numpy if torch_side else jnp.asarray
    ctx = None if variant in ("uncond", "legacy") else conv(a["ctx"])
    y = conv(a["y"]).long() if torch_side else conv(a["y"])
    return (conv(a["x"]), conv(a["t"]), ctx,
            y if variant == "classes" else None)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("variant,dt,impl", [
    ("context", "f32", "xla"), ("uncond", "f32", "xla"),
    ("classes", "f32", "xla"), ("legacy", "f32", "xla"),
    ("context", "f32", "pallas"), ("legacy", "f32", "pallas"),
    ("context", "bf16", "xla"), ("uncond", "bf16", "pallas"),
])
def test_unet_matches_jax(variant, dt, impl):
    """"classes" is class-conditional with use_scale_shift_norm."""
    jm, tm = _pair(variant, dt, impl)
    a = _inputs(1)
    ref, _ = jax.jit(jm.apply)(_params(variant), *_args(variant, a, False))
    with torch.no_grad():
        out, _ = tm(*_args(variant, a, True))
    assert out.shape == (2, 16, 16, 4) and out.dtype == DTYPES[dt][1]
    o, r = _np(out), _np(ref)
    tol = DTYPES[dt][2]
    if dt == "bf16":
        assert np.linalg.norm(o - r) <= tol * np.linalg.norm(r)
        tol *= float(np.abs(r).max())
    np.testing.assert_allclose(o, r, rtol=0, atol=tol)


def test_unet_euler4_decode_matches_jax():
    """An Euler-4 core.flow.decode of the toy field against JAX's."""
    jm, tm = _pair("context")
    a = _inputs(2)
    sk = {"solver": "fixed", "solver_fix": "euler", "solver_fix_step": 0.25}
    params = _params("context")
    ctx = jnp.asarray(a["ctx"])
    ref = jax.jit(lambda z: jflow.decode(
        lambda t, x: jm.apply(params, x, t, ctx)[0], z, sk))(
            jnp.asarray(a["x"]))
    tctx = torch.from_numpy(a["ctx"])
    with torch.no_grad():
        out = tflow.decode(lambda t, x: tm(x, t, tctx)[0],
                           torch.from_numpy(a["x"]), sk)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["context", "legacy"])
def test_init_weights_keeps_the_reference_zero_init(variant):
    """init_weights zeroes the output convs, so the field starts at zero as
    the JAX UNet's init does; zero_init_std draws those convs' weights from
    normal x the std and changes how no other tensor is drawn."""
    cfg = dict(TINY, **VARIANTS[variant])
    m = UNet(**cfg, device="cpu").init_weights(torch.Generator().manual_seed(5))
    zero = {f"{n}.weight" for n, mod in m.named_modules()
            if any(mod is c for c in m._zero_init_convs())}
    assert len(zero) == 13  # 8 ResBlocks, 4 attention blocks, out.2
    a = _inputs(5)
    x, t = torch.from_numpy(a["x"]), torch.from_numpy(a["t"])
    with torch.no_grad():
        v, _ = m(x, t)
    assert not v.any()
    ref = m.state_dict()
    assert not any(ref[k].any() for k in zero)
    live = UNet(**cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(5), zero_init_std=ZERO_INIT_STD)
    for k, p in live.state_dict().items():
        if k in zero:
            assert 0.8 < float(p.std()) / ZERO_INIT_STD < 1.2
        elif not k.endswith(".weight") or p.dim() < 2:
            assert torch.equal(p, ref[k])  # norms and biases
    with torch.no_grad():
        v, _ = live(x, t)
    assert float(v.abs().max()) > 1e-3


def test_taps_shapes_and_routing():
    """Taps, the zeros context token, and the self-attention routes: the
    toy's attention at 8 x 8 (L = 64) is plain math under auto."""
    _, tm = _pair("context")
    a = _inputs(3)
    tattn.reset_launches()
    with torch.no_grad():
        v, taps = tm(*_args("context", a, True), capture=("head", "mid",
                                                          "tail"))
        v0, _ = tm(torch.from_numpy(a["x"]), torch.from_numpy(a["t"]))
        vz, _ = tm(torch.from_numpy(a["x"]), torch.from_numpy(a["t"]),
                   torch.zeros(2, 1, 24))
    assert taps["mid"].shape == (2, 8, 8, 64)  # ds 2, ch 2 * 32
    assert torch.equal(taps["tail"], v) and taps["head"].shape == v.shape
    assert torch.equal(v0, vz) and float((v - v0).abs().max()) > 1e-6
    assert set(tattn.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="unknown taps"):
        tm(torch.from_numpy(a["x"]), torch.from_numpy(a["t"]),
           capture=("nope",))


def test_nearest_upsample_and_group_norm_match_jax():
    """x2 nearest upsampling equals jax.image.resize "nearest"; group_norm
    equals Flax's GroupNorm (fast variance) at gcd(32, C) groups."""
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 5, 3, 48)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 10, 6, 48), "nearest")
    assert np.array_equal(upsample_nearest2x(torch.from_numpy(x)).numpy(),
                          np.asarray(ref))
    from flax import linen as fnn

    gn = fnn.GroupNorm(num_groups=16, epsilon=1e-5)
    p = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    w = (1 + 0.1 * r.standard_normal(48)).astype(np.float32)
    b = (0.1 * r.standard_normal(48)).astype(np.float32)
    p = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}
    ref = gn.apply(p, jnp.asarray(x + 3.0))
    out = group_norm(torch.from_numpy(x + 3.0), torch.from_numpy(w),
                     torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_unported_views_raise():
    """The int8 views and per-block remat build; an unknown view or
    attn_impl still raises; the edit hook, once refused, now writes."""
    for q in (True, "conv8", "w8a8", "dense8"):
        assert UNet(**TINY, quant=q, device="cpu").quant == q
    assert UNet(**TINY, use_checkpoint=True, device="cpu").use_checkpoint
    with pytest.raises(ValueError, match="unknown quant view"):
        UNet(**TINY, quant="w8", device="cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        UNet(**TINY, attn_impl="pallas_packed", device="cpu")
    tm = get_nnet("unet_t2i", **TINY, device="cpu")
    assert isinstance(tm, UNet)
    x = torch.zeros(1, 16, 16, 4)
    edit = USpaceEdit(delta_grid=torch.ones(2, 16, 16, 4), scale=0.5,
                      grid_dt=0.5, loc="head")
    with torch.no_grad():
        _, taps = tm(x, torch.full((1,), 0.5), edit=edit, capture=("head",))
    assert torch.equal(taps["head"], x + 0.5)
