"""uspace_tpu_torch SD-VAE held to the JAX VAE (uspace_tpu/codecs/vae.py),
and the sampling entry point's pixel output.

The toy VAE of tests/test_codecs.py (TINY_DD) with seeded weights: one Flax
param tree given to JAX and, through ``load_vae_from_jax`` (strict=True),
to the port; inputs from numpy seeds. Tolerance: f32 1e-4 of the output's
scale (the same arithmetic summed in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.codecs.convert import unet_torch_to_flax, vae_torch_to_flax
from uspace_tpu.codecs.vae import AutoencoderKL as JaxVAE
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import load_vae_from_jax, unflatten
from uspace_tpu_torch.codecs.vae import AutoencoderKL, f32_precision
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.models.layers import Int8Conv

TINY_DD = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
               attn_resolutions=(), in_channels=3, resolution=32,
               z_channels=4, double_z=True)


@pytest.fixture(scope="module")
def pair():
    src = AutoencoderKL(TINY_DD, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    params = {"params": vae_torch_to_flax(src.state_dict())}
    vae = load_vae_from_jax(AutoencoderKL(TINY_DD, device="cpu"), params)
    return JaxVAE(ddconfig=TINY_DD, embed_dim=4), params, vae.eval()


def _close(port, ref, tol=1e-4):
    p, r = port.detach().numpy(), np.asarray(ref)
    np.testing.assert_allclose(p, r, rtol=0,
                               atol=tol * max(1.0, float(np.abs(r).max())))


def test_encode_moments_and_decode_match_jax(pair):
    jv, params, vae = pair
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = r.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ref_m = jax.jit(lambda p, x: jv.apply(p, x, method=jv.encode_moments))(
        params, jnp.asarray(x))
    ref_d = jax.jit(lambda p, z: jv.apply(p, z, method=jv.decode))(
        params, jnp.asarray(z))
    with torch.no_grad():
        m = vae.encode_moments(torch.from_numpy(x))
        d = vae.decode(torch.from_numpy(z))
    assert m.shape == (2, 16, 16, 8) and d.shape == (2, 32, 32, 3)
    _close(m, ref_m)
    _close(d, ref_d)


def test_sample_statistics_from_an_explicit_generator(pair):
    _, _, vae = pair
    mean = torch.full((1, 4, 4, 4), 2.0)
    clipped = torch.cat([mean, torch.full_like(mean, -40.0)], dim=-1)
    z = vae.sample(clipped, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(z.numpy(), 2.0 * 0.18215, atol=1e-6)
    moments = torch.cat([torch.full((64, 8, 8, 4), 1.0),
                         torch.full((64, 8, 8, 4), float(np.log(4.0)))], -1)
    a = vae.sample(moments, torch.Generator().manual_seed(1)) / 0.18215
    b = vae.sample(moments, torch.Generator().manual_seed(1)) / 0.18215
    c = vae.sample(moments, torch.Generator().manual_seed(2)) / 0.18215
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.mean()) - 1.0) < 0.03  # 16384 draws of N(1, 2^2)
    assert abs(float(a.std()) - 2.0) < 0.03
    enc = vae.encode(torch.zeros(1, 32, 32, 3), torch.Generator())
    assert enc.shape == (1, 16, 16, 4)


def test_f32_precision_and_unported_view():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with f32_precision():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
    # the int8 decode view builds: the decoder's 3x3 convs are Int8Conv
    q = AutoencoderKL(TINY_DD, quant=True, device="cpu")
    assert isinstance(q.decoder.mid.block_1.conv1, Int8Conv)
    assert not isinstance(q.encoder.mid.block_1.conv1, Int8Conv)


def test_sample_lfm_decodes_uint8_pixels(tmp_path):
    """The UNet entry point with --decode on the CPU, its JAX-layout field
    and VAE weights given as .npz: latents and uint8 pixel batches, the
    pixels those of the loaded VAE."""
    cfg = get_config("synthetic_unet")
    dev = torch.device("cpu")
    field = sample_lfm.build_model(cfg, dev, seed=3)
    vae = sample_lfm.build_vae(cfg, dev, seed=4)
    files = {}
    for name, tree in (("f", unet_torch_to_flax(field.state_dict())),
                       ("v", vae_torch_to_flax(vae.state_dict()))):
        files[name] = str(tmp_path / f"{name}.npz")
        np.savez(files[name], **_flat(tree))
    out = tmp_path / "s"
    sample_lfm.main(["--config", "synthetic_unet", "--decode", "--device",
                     "cpu", "--n_samples", "3", "--batch", "2", "--steps",
                     "2", "--weights", files["f"], "--vae_weights",
                     files["v"], "--out", str(out)])
    assert sorted(os.listdir(out)) == ["0.npy", "0.pixels.npy", "2.npy",
                                       "2.pixels.npy"]
    lat = np.load(out / "0.npy")
    pix = np.load(out / "0.pixels.npy")
    assert lat.shape == (2, 16, 16, 4) and np.isfinite(lat).all()
    assert pix.shape == (2, 128, 128, 3) and pix.dtype == np.uint8
    loaded = load_vae_from_jax(AutoencoderKL.from_config(cfg["autoencoder"],
                                                         device="cpu"),
                               unflatten(dict(np.load(files["v"]))))
    with torch.no_grad():
        want = sample_lfm.to_uint8(loaded.decode(torch.from_numpy(lat)))
    assert np.array_equal(pix, want)
    assert np.load(out / "2.pixels.npy").shape == (1, 128, 128, 3)
    # the U-ViT configs decode the same way
    paths = sample_lfm.run("synthetic_smoke", n_samples=1, batch=1, steps=1,
                           out=str(tmp_path / "u"), device="cpu",
                           decode=True)
    assert np.load(paths[1]).shape == (1, 64, 64, 3)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out
