"""uspace_tpu_torch.models: the U-ViT port held to the JAX U-ViT.

A toy field is initialised in JAX, carried across with
``load_uvit_from_jax`` (``strict=True``) and both packages are applied to
the same numpy inputs. Tolerances: f32 1e-4 (twenty-odd matmuls summed in
another order), bf16 2e-2 (a few bf16 roundings of O(1) activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.codecs.convert import uvit_flax_to_torch as jax_flax_to_torch
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.models import layers as jlayers
from uspace_tpu_torch.codecs.convert import (
    _flatten,
    load_uvit_from_jax,
    unflatten,
    uvit_flax_to_torch,
)
from uspace_tpu_torch.models import UViT, get_nnet
from uspace_tpu_torch.models import layers as tlayers

TAPS = ("head", "mid", "tail")
TOYS = {
    "uncond": dict(depth=2),
    "cond_mlp_time": dict(depth=4, num_classes=5, mlp_time_embed=True),
}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _cfg(toy):
    return dict(img_size=8, patch_size=2, in_chans=4, embed_dim=64,
                num_heads=4, **TOYS[toy])


def _data(toy, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.full((2,), 0.3, np.float32)
    y = np.array([1, 3]) if "num_classes" in TOYS[toy] else None
    return x, t, y


@pytest.fixture(scope="module")
def jax_params():
    """Flax params of each toy (numpy trees), initialised once."""
    out = {}
    for toy in TOYS:
        x, t, y = _data(toy)
        p = jax.jit(JaxUViT(**_cfg(toy)).init)(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
            None if y is None else jnp.asarray(y))
        out[toy] = jax.tree.map(np.asarray, p)
    return out


def _port(toy, params, dtype=torch.float32, attn_impl="auto"):
    m = UViT(dtype=dtype, attn_impl=attn_impl, device="cpu", **_cfg(toy))
    return load_uvit_from_jax(m, params).eval()


def _apply_jax(toy, params, dtype=torch.float32, attn_impl="auto"):
    x, t, y = _data(toy)
    m = JaxUViT(dtype=JDT[dtype], attn_impl=attn_impl, **_cfg(toy))
    v, taps = m.apply(params, jnp.asarray(x), jnp.asarray(t),
                      None if y is None else jnp.asarray(y), capture=TAPS)
    return v, taps


@torch.no_grad()
def _apply_port(toy, model):
    x, t, y = _data(toy)
    return model(torch.from_numpy(x), torch.from_numpy(t),
                 None if y is None else torch.from_numpy(y), capture=TAPS)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("toy,dtype,tol", [
    ("uncond", torch.float32, 1e-4),
    ("uncond", torch.bfloat16, 2e-2),
    ("cond_mlp_time", torch.float32, 1e-4),
])
def test_uvit_matches_jax(jax_params, toy, dtype, tol):
    """Velocity and capture taps vs JAX (plain attention on both sides)."""
    p = jax_params[toy]
    jv, jtaps = _apply_jax(toy, p, dtype)
    tv, ttaps = _apply_port(toy, _port(toy, p, dtype))
    assert tv.dtype == dtype and tuple(tv.shape) == (2, 8, 8, 4)
    _close(tv, jv, tol)
    assert set(ttaps) == set(jtaps) == set(TAPS)
    for k in TAPS:
        assert ttaps[k].shape == jtaps[k].shape
        _close(ttaps[k], jtaps[k], tol)


def test_uvit_fused_qkvproj_matches_jax_pallas(jax_params):
    """The fused-attention route, JAX Pallas interpret vs the port's twin."""
    p = jax_params["uncond"]
    jv, _ = _apply_jax("uncond", p, attn_impl="pallas_qkvproj")
    tv, _ = _apply_port("uncond", _port("uncond", p,
                                        attn_impl="pallas_qkvproj"))
    _close(tv, jv, 1e-4)


@pytest.mark.parametrize("impl", ["pallas_packed", "pallas_lnmlp",
                                  "pallas_qkvproj"])
def test_kernel_routes_agree_with_plain_route(jax_params, impl):
    """Every kernel route of the port equals its plain route in f32 (the
    twins' arithmetic is the plain path's up to normalisation order)."""
    p = jax_params["cond_mlp_time"]
    ref, _ = _apply_port("cond_mlp_time", _port("cond_mlp_time", p,
                                                attn_impl="xla"))
    out, _ = _apply_port("cond_mlp_time", _port("cond_mlp_time", p,
                                                attn_impl=impl))
    _close(out, ref, 1e-5)


def test_converter_copy_matches_jax_converter(jax_params):
    for p in jax_params.values():
        a, b = jax_flax_to_torch(p), uvit_flax_to_torch(p)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_strict_load_refuses_missing_and_extra_keys(jax_params):
    p = jax_params["uncond"]
    flat = {"/".join(k): v for k, v in _flatten(p["params"]).items()}
    dropped = {k: v for k, v in flat.items() if "decoder_pred" not in k}
    m = UViT(device="cpu", **_cfg("uncond"))
    with pytest.raises(RuntimeError, match="decoder_pred"):
        load_uvit_from_jax(m, unflatten(dropped))
    extra = dict(flat, **{"bogus/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="bogus"):
        load_uvit_from_jax(m, unflatten(extra))
    load_uvit_from_jax(m, {"params": unflatten(flat)})


def test_layer_helpers_match_jax():
    r = np.random.default_rng(5)
    t = r.random(6).astype(np.float32)
    for dim in (64, 33):
        _close(tlayers.timestep_embedding(torch.from_numpy(t), dim),
               jlayers.timestep_embedding(jnp.asarray(t), dim), 1e-6)
    img = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    tok = tlayers.patchify(torch.from_numpy(img), 2)
    _close(tok, jlayers.patchify(jnp.asarray(img), 2), 0)
    _close(tlayers.unpatchify(tok, 4), img, 0)
    x = (3 + 2 * r.standard_normal((2, 5, 64))).astype(np.float32)
    from flax import linen as nn

    for td in (torch.float32, torch.bfloat16):
        ln = nn.LayerNorm(epsilon=1e-5, dtype=JDT[td])
        ref = ln.apply(ln.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                       jnp.asarray(x))
        out = tlayers.LayerNorm(64, dtype=td)(torch.from_numpy(x))
        assert out.dtype == td
        _close(out.detach(), ref, 1e-5 if td == torch.float32 else 2e-2)


def test_unported_options_raise():
    # pallas_block, once refused here, builds in every view
    # (tests/test_torch_block.py holds it to JAX)
    UViT(quant=True, attn_impl="pallas_block", device="cpu", **_cfg("uncond"))
    tlayers.Block(64, 4, quant="w8", attn_impl="pallas_block")
    tlayers.Attention(64, 4, attn_impl="pallas_block")
    with pytest.raises(NotImplementedError):  # a field no slice ports
        get_nnet("uvit_nope", device="cpu")
    get_nnet("uvit_t2i", device="cpu", img_size=8, embed_dim=64, depth=2,
             num_heads=4, clip_dim=16, num_clip_token=4)  # ported in the T2I slice
    with pytest.raises(ValueError, match="attn_impl"):
        tlayers.Attention(64, 4, attn_impl="pallas_nope")
    m = UViT(device="cpu", **_cfg("cond_mlp_time"))
    with pytest.raises(ValueError, match="labels"):
        m(torch.zeros(1, 8, 8, 4), torch.zeros(1))
    with pytest.raises(ValueError, match="unknown taps"):
        m(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1).long(),
          capture=("nope",))


def test_seeded_init_is_reproducible_and_named_like_reference():
    a = get_nnet("uvit", device="cpu", use_checkpoint=True, remat_exempt=3,
                 **_cfg("cond_mlp_time"))
    b = get_nnet("uvit", device="cpu", **_cfg("cond_mlp_time"))
    for m in (a, b):
        m.init_weights(torch.Generator().manual_seed(7))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert {"pos_embed", "time_embed.0.weight", "label_emb.weight",
            "out_blocks.1.skip_linear.weight", "final_layer.weight",
            "mid_block.attn.qkv.weight"} <= set(sa)
    assert float(sa["in_blocks.0.attn.qkv.weight"].abs().max()) <= 0.04
    assert torch.equal(sa["norm.weight"], torch.ones(64))
