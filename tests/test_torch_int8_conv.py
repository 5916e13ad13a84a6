"""uspace_tpu_torch int8 convs held to the JAX package's.

``ops/quant.quantize_convwise`` and ``int8_conv`` against
``uspace_tpu/ops/quant.py`` (the cases of ``tests/test_quant.py``
``TestInt8Conv``), the SD-UNet's int8 views (``True``/``"conv8"``,
``"w8a8"``, ``"dense8"``) on the toy UNet of ``TestUNetQuantView``, and the
SD-VAE's int8 decode view on ``TINY_DD`` of ``tests/test_codecs.py``. One
param tree reaches both packages through ``codecs/convert`` with
``strict=True``; the UNet's zero-initialised output convs are drawn live
(``ZERO_INIT_STD``), or the comparison would hold zeros. The int32 sums are
exact on both sides, so codes and scales are bit-equal and f32 outputs
agree to 1e-6 of their scale; a bf16 conv output to one bf16 step. In the
models every int8 call of the port is held so against the JAX function on
its own inputs, and the port makes the JAX model's calls; the whole
field is held to ``VIEW_MAX_REL_L2`` (an int8 code that flips where an
f32 sum runs in another order moves every later quantizer).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.codecs.convert import unet_torch_to_flax, vae_torch_to_flax
from uspace_tpu.codecs.vae import AutoencoderKL as JaxVAE
from uspace_tpu.models.unet import UNet as JaxUNet
from uspace_tpu.ops import quant as jquant
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import load_unet_from_jax, load_vae_from_jax
from uspace_tpu_torch.codecs.vae import AutoencoderKL
from uspace_tpu_torch.models import layers
from uspace_tpu_torch.models.layers import Conv2d, Int8Conv
from uspace_tpu_torch.models.unet import ZERO_INIT_STD, UNet
from uspace_tpu_torch.ops import quant

UNET = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
            attention_resolutions=(2, 1), num_res_blocks=1,
            channel_mult=(1, 2), num_head_channels=16,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=24)
TINY_DD = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
               attn_resolutions=(), in_channels=3, resolution=32,
               z_channels=4, double_z=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_step(top):
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _close(port, ref, tol, bf16=False):
    """f32: within ``tol`` of the reference's largest value; bf16: within
    one bf16 step of it."""
    p, r = _np(port), _np(ref)
    top = float(np.abs(r).max())
    np.testing.assert_allclose(p, r, rtol=0,
                               atol=_bf16_step(top) if bf16 else tol * top)


def _conv_ref(x, w_hwio, strides, padding):
    dn = jax.lax.conv_dimension_numbers(x.shape, w_hwio.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(x, w_hwio, strides, padding,
                                        dimension_numbers=dn)


def test_quantize_convwise_is_bit_equal_to_jax():
    r = np.random.default_rng(0)
    w = (r.standard_normal((3, 3, 16, 24)) * 0.05).astype(np.float32)
    w[:, :, :, 3] = 0.0  # an all-zero channel: amax clamped at 1e-8
    q_j, s_j = jquant.quantize_convwise(jnp.asarray(w))
    q, s = quant.quantize_convwise(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("case", ["grid", "same_bias", "k3s2", "bf16"])
def test_int8_conv_matches_jax(case):
    """On the int8 grid (scales exactly 1: the product is exact); SAME (k3
    padded 1) with a bias; the Downsample's k3 s2 padded ((1, 1), (1, 1));
    and a bf16 input and output. The exact f32 conv backs the grid case."""
    r = np.random.default_rng(1)
    strides, pad = ((2, 2), ((1, 1), (1, 1))) if case == "k3s2" else \
        ((1, 1), ((1, 1), (1, 1)))
    if case == "grid":
        x = r.integers(-127, 128, (2, 8, 8, 16)).astype(np.float32)
        x[:, 0, 0, 0] = 127.0
        w = r.integers(-127, 128, (3, 3, 16, 24)).astype(np.float32)
        w[0, 0, 0, :] = 127.0
    else:
        x = r.standard_normal((2, 8, 8, 32)).astype(np.float32)
        w = (r.standard_normal((3, 3, 32, 40)) * 0.05).astype(np.float32)
    b = (0.1 * r.standard_normal(w.shape[-1])).astype(np.float32) \
        if case == "same_bias" else None
    jd, td = DTYPES["bf16" if case == "bf16" else "f32"]
    ref = jquant.int8_conv(jnp.asarray(x, jd), jnp.asarray(w),
                           None if b is None else jnp.asarray(b), strides,
                           pad)
    out = quant.int8_conv(torch.from_numpy(x).to(td),
                          torch.from_numpy(w.transpose(3, 2, 0, 1)),
                          None if b is None else torch.from_numpy(b),
                          strides, (1, 1))
    assert out.dtype == td and out.shape == ref.shape
    _close(out, ref, 1e-6, bf16=case == "bf16")
    if case == "grid":
        exact = _conv_ref(jnp.asarray(x), jnp.asarray(w), strides, pad)
        np.testing.assert_array_equal(_np(out), np.asarray(exact))


def test_int8_conv_weight_is_quantized_once():
    """The conv codes are cached per weight value, counted by
    QUANTIZATIONS, and re-made after an in-place update."""
    conv = Int8Conv(8, 16, 3, padding=1, device="cpu")
    x = torch.randn(2, 8, 8, 8)
    quant.reset_quantizations()
    a = conv.nhwc(x)
    conv.nhwc(x)
    assert quant.QUANTIZATIONS["weights"] == 1
    with torch.no_grad():
        conv.weight.mul_(2.0)
    conv.nhwc(x)
    assert quant.QUANTIZATIONS["weights"] == 2
    assert a.shape == (2, 8, 8, 16)


def test_int8_conv_layer_has_conv2d_parameters():
    """Int8Conv keeps Conv2d's state dict (f32 weight and bias), so one
    state dict loads into either view; its NCHW forward is its NHWC one."""
    a = Conv2d(8, 16, 3, padding=1, dtype=torch.bfloat16, device="cpu")
    q = Int8Conv(8, 16, 3, padding=1, dtype=torch.bfloat16, device="cpu")
    sa, sq = a.state_dict(), q.state_dict()
    assert sa.keys() == sq.keys()
    assert all(sa[k].shape == sq[k].shape for k in sa)
    assert all(v.dtype == torch.float32 for v in sq.values())
    q.load_state_dict(sa)
    x = torch.randn(2, 8, 6, 6)
    assert torch.equal(q(x), q.nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))


@pytest.fixture(scope="module")
def unet_params():
    m = UNet(**UNET, device="cpu").init_weights(
        torch.Generator().manual_seed(3), zero_init_std=ZERO_INIT_STD)
    return m.state_dict(), {"params": jax.tree.map(
        np.asarray, unet_torch_to_flax(m.state_dict()))}


def _record_int8(monkeypatch):
    """Record every int8 conv and dense call of a forward, on both sides:
    the JAX package's (kind, input shape, HWIO or [K, N] weight shape) and
    the port's calls with their arguments and outputs."""
    jcalls, tcalls = [], []
    j_conv, j_dense = jquant.int8_conv, jquant.int8_dense
    t_conv, t_dense = layers.int8_conv, layers.int8_dense

    def jc(x, w, *a, **k):
        jcalls.append(("conv", tuple(x.shape), tuple(w.shape)))
        return j_conv(x, w, *a, **k)

    def jd(x, w, *a, **k):
        jcalls.append(("dense", tuple(x.shape), tuple(w.shape)))
        return j_dense(x, w, *a, **k)

    def tc(x, w, bias, stride, padding, out_dtype):
        out = t_conv(x, w, bias, stride, padding, out_dtype)
        tcalls.append(("conv", x, w, bias, stride, padding, out))
        return out

    def td(x, w, bias=None, out_dtype=None):
        out = t_dense(x, w, bias, out_dtype)
        tcalls.append(("dense", x, w, bias, None, None, out))
        return out

    monkeypatch.setattr(jquant, "int8_conv", jc)
    monkeypatch.setattr(jquant, "int8_dense", jd)
    monkeypatch.setattr(layers, "int8_conv", tc)
    monkeypatch.setattr(layers, "int8_dense", td)
    return jcalls, tcalls, j_conv, j_dense


def _check_int8_calls(jcalls, tcalls, j_conv, j_dense):
    """The port makes the JAX model's int8 calls (same kinds and shapes),
    and each of its calls equals the JAX function on the same inputs, run
    op by op (under jit XLA may turn x / scale into a product with the
    reciprocal and flip a code): f32 within 1e-6 of the output's scale,
    bf16 within one bf16 step."""
    def jshape(kind, x, w):
        return (kind, tuple(x.shape), tuple(w.permute(2, 3, 1, 0).shape)
                if kind == "conv" else tuple(w.shape))

    assert sorted(jshape(c[0], c[1], c[2]) for c in tcalls) == sorted(jcalls)
    for kind, x, w, b, stride, padding, out in tcalls:
        jx = jnp.asarray(_np(x), DTYPES["bf16" if x.dtype == torch.bfloat16
                                       else "f32"][0])
        jb = None if b is None else jnp.asarray(_np(b))
        od = DTYPES["bf16" if out.dtype == torch.bfloat16 else "f32"][0]
        if kind == "conv":
            ref = j_conv(jx, jnp.asarray(_np(w).transpose(2, 3, 1, 0)), jb,
                         stride, tuple((p, p) for p in padding), od)
        else:
            ref = j_dense(jx, jnp.asarray(_np(w)), jb, od)
        _close(out, ref, 1e-6, bf16=out.dtype == torch.bfloat16)


# the whole field of an int8 view against JAX's: a code that flips where an
# f32 sum runs in another order moves every later quantizer, so the two
# packages' int8 fields sit about as far apart as each sits from the plain
# view (measured on the toy, f32: 1.6e-2 to 1.9e-2 apart, 2.9e-2 from the
# plain view; dense8 5.7e-3 and 7.8e-3); the calls above are the tight check
VIEW_MIN_COS, VIEW_MAX_REL_L2 = 0.999, 5e-2


@pytest.mark.parametrize("view,dt,ctx", [
    (True, "f32", True), ("w8a8", "f32", False), ("dense8", "f32", True),
    (True, "bf16", False), ("w8a8", "bf16", True),
])
def test_unet_int8_views_match_jax(unet_params, monkeypatch, view, dt, ctx):
    """Each int8 view of the toy UNet against JAX's, with and without a
    context: the same int8 calls, each equal to JAX's function on its
    inputs, and the field within the view limits; the plain view's state
    dict loads into it strictly."""
    sd, params = unet_params
    jd, td = DTYPES[dt]
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    c = r.standard_normal((2, 7, 24)).astype(np.float32) if ctx else None
    jcalls, tcalls, j_conv, j_dense = _record_int8(monkeypatch)
    jm = JaxUNet(**UNET, dtype=jd, quant=view)
    ref, _ = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t),
                               None if c is None else jnp.asarray(c))
    tm = UNet(**UNET, dtype=td, param_dtype=torch.float32, quant=view,
              device="cpu")
    tm.load_state_dict(sd, strict=True)
    load_unet_from_jax(tm, params)
    with torch.no_grad():
        out, _ = tm(torch.from_numpy(x), torch.from_numpy(t),
                    None if c is None else torch.from_numpy(c))
    assert out.dtype == td and out.shape == (2, 16, 16, 4)
    _check_int8_calls(jcalls, tcalls, j_conv, j_dense)
    o, r_ = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    rel = np.linalg.norm(o - r_) / np.linalg.norm(r_)
    cos = (o * r_).sum() / (np.linalg.norm(o) * np.linalg.norm(r_))
    assert cos >= VIEW_MIN_COS and rel <= VIEW_MAX_REL_L2, (cos, rel)


def test_unet_int8_routing():
    """Which layers each view quantizes: the convs of the ResBlocks, the
    resamplers and the transformers' proj_in/proj_out in the conv views;
    the transformer denses in the dense views; never the boundary convs,
    the 1x1 skip, the embedding layers or AttnBlockLegacy."""
    def int8(m):
        convs = {n for n, mod in m.named_modules()
                 if isinstance(mod, Int8Conv)}
        dense = {n for n, mod in m.named_modules()
                 if isinstance(mod, layers.Dense) and mod.quant}
        return convs, dense

    cfg = dict(UNET, attention_resolutions=(2,))
    convs, dense = int8(UNet(**cfg, quant=True, device="cpu"))
    assert "input_blocks.1.0.in_layers.2" in convs
    assert "input_blocks.2.0.op" in convs  # Downsample
    assert "output_blocks.1.2.conv" in convs  # Upsample
    assert "input_blocks.3.1.proj_in" in convs and not dense
    assert not {"input_blocks.0.0", "out.2",
                "input_blocks.3.0.skip_connection"} & convs
    convs8, dense8 = int8(UNet(**cfg, quant="dense8", device="cpu"))
    assert not convs8
    assert {"input_blocks.3.1.transformer_blocks.0.attn1.to_q",
            "input_blocks.3.1.transformer_blocks.0.ff.net.0.proj"} <= dense8
    assert not any("time_embed" in n or "emb_layers" in n for n in dense8)
    convs_w, dense_w = int8(UNet(**cfg, quant="w8a8", device="cpu"))
    assert convs_w == convs and dense_w == dense8
    legacy = UNet(**dict(cfg, use_spatial_transformer=False), quant=True,
                  device="cpu")
    assert not any(".qkv" in n or "proj_out" in n for n in int8(legacy)[0])


def test_vae_int8_decode_matches_jax(monkeypatch):
    """AutoencoderKL(quant=True) decodes as the JAX package's int8 view:
    the same int8 calls, each equal to JAX's function on its inputs, the
    decode within the view limits of JAX's and near the f32 decode; the
    plain view's params load into it."""
    vae = AutoencoderKL(TINY_DD, device="cpu").init_weights(
        torch.Generator().manual_seed(5))
    params = {"params": jax.tree.map(np.asarray,
                                     vae_torch_to_flax(vae.state_dict()))}
    jcalls, tcalls, j_conv, j_dense = _record_int8(monkeypatch)
    jv = JaxVAE(ddconfig=TINY_DD, embed_dim=4, quant=True)
    z = np.random.default_rng(6).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    ref = jax.jit(lambda p, z: jv.apply(p, z, method=jv.decode))(
        params, jnp.asarray(z))
    q = load_vae_from_jax(AutoencoderKL(TINY_DD, quant=True, device="cpu"),
                          params)
    with torch.no_grad():
        out = q.decode(torch.from_numpy(z))
        plain = vae.decode(torch.from_numpy(z))
    assert out.shape == (2, 32, 32, 3)
    _check_int8_calls(jcalls, tcalls, j_conv, j_dense)
    o, r_ = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    assert np.linalg.norm(o - r_) / np.linalg.norm(r_) <= VIEW_MAX_REL_L2
    rel = float((out - plain).norm() / plain.norm())
    assert 0 < rel < 0.05


def test_sample_lfm_quant_decode_writes_pixels(tmp_path):
    """The entry point with --quant --decode on the CPU: the UNet's conv
    view and the VAE's int8 decode view write latents and uint8 pixels."""
    out = tmp_path / "q"
    sample_lfm.main(["--config", "synthetic_unet", "--quant", "--decode",
                     "--device", "cpu", "--n_samples", "2", "--batch", "2",
                     "--steps", "2", "--out", str(out)])
    assert sorted(os.listdir(out)) == ["0.npy", "0.pixels.npy"]
    lat = np.load(out / "0.npy")
    pix = np.load(out / "0.pixels.npy")
    assert lat.shape == (2, 16, 16, 4) and np.isfinite(lat).all()
    assert pix.shape == (2, 128, 128, 3) and pix.dtype == np.uint8
