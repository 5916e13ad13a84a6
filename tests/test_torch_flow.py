"""uspace_tpu_torch.core and the sampling slice held to the JAX package.

Solvers are compared on a linear field with a known solution; the slice as
a whole is a toy U-ViT's ``flow.decode`` with Euler-8 from one numpy ``z``
through both packages, and the ``sample_lfm`` entry point on the CPU.
Tolerances: f32 1e-5 for the solvers (the same arithmetic), 1e-4 for the
decode (the field's f32 tolerance), bf16 fields 2e-2.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.core import flow as jflow
from uspace_tpu.core import solvers as jsolvers
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import _flatten, load_uvit_from_jax
from uspace_tpu_torch.core import flow as tflow
from uspace_tpu_torch.core import solvers as tsolvers
from uspace_tpu_torch.models import UViT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A = np.array([[-0.5, 1.0], [-1.0, -0.5]], np.float32)


def _jax_field(has_aux, dtype=jnp.float32):
    a = jnp.asarray(A)

    def vf(t, x):
        v = (x @ a.T + t).astype(dtype)
        return (v, {"t": t, "x": x}) if has_aux else v

    return vf


def _port_field(has_aux, dtype=torch.float32):
    a = torch.from_numpy(A)

    def vf(t, x):
        v = (x @ a.T + t).to(dtype)
        return (v, {"t": t, "x": x}) if has_aux else v

    return vf


@pytest.mark.parametrize("method", tsolvers.FIXED_METHODS)
@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (1.0, 0.0)])
@pytest.mark.parametrize("has_aux", [False, True])
def test_odeint_fixed_matches_jax(method, t0, t1, has_aux):
    x0 = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)
    ref = jsolvers.odeint_fixed(_jax_field(has_aux), jnp.asarray(x0), t0, t1,
                                10, method=method, has_aux=has_aux)
    out = tsolvers.odeint_fixed(_port_field(has_aux), torch.from_numpy(x0),
                                t0, t1, 10, method=method, has_aux=has_aux)
    if has_aux:
        (ref, raux), (out, oaux) = ref, out
        assert set(raux) == set(oaux)
        for k in raux:
            assert tuple(oaux[k].shape) == raux[k].shape
            np.testing.assert_allclose(oaux[k].numpy(), np.asarray(raux[k]),
                                       atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_rk4_reaches_closed_form_and_inverts():
    """dx/dt = A x: x(1) = expm(A) x0, and integrating back returns x0."""
    from scipy.linalg import expm

    x0 = torch.tensor([[1.0, -2.0]], dtype=torch.float64)
    f = lambda t, x: x @ torch.from_numpy(A).double().T
    x1 = tsolvers.odeint_fixed(f, x0, 0.0, 1.0, 50, method="rk4")
    # global error of rk4 at h = 0.02 is O(h^4) ~ 1e-7
    np.testing.assert_allclose(x1.numpy(), x0.numpy() @ expm(A).T, atol=1e-6)
    back = tsolvers.odeint_fixed(f, x1, 1.0, 0.0, 50, method="rk4")
    np.testing.assert_allclose(back.numpy(), x0.numpy(), atol=1e-6)


def test_bf16_field_advances_f32_state_like_jax():
    """The step multiplies in the field's dtype (JAX weak typing: bf16(dt)
    times the bf16 velocity, rounded to bf16), so an f32 state driven by a
    bf16 field takes exactly the JAX sampler's steps. The field does not
    depend on x, so the two runs see identical velocities."""
    c = np.random.default_rng(1).standard_normal((64,)).astype(np.float32)
    x0 = np.zeros((64,), np.float32)
    ref = jsolvers.odeint_fixed(
        lambda t, x: (jnp.asarray(c) * (1 + t)).astype(jnp.bfloat16),
        jnp.asarray(x0), 0.0, 1.0, 50)
    out = tsolvers.odeint_fixed(
        lambda t, x: (torch.from_numpy(c) * (1 + t)).to(torch.bfloat16),
        torch.from_numpy(x0), 0.0, 1.0, 50)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_odeint_dispatch():
    f = _port_field(False)
    x0 = torch.ones(1, 2)
    sk = {"solver": "fixed", "solver_fix": "midpoint", "solver_fix_step": 0.1}
    np.testing.assert_array_equal(
        tsolvers.odeint(f, x0, 0.0, 1.0, sk).numpy(),
        tsolvers.odeint_fixed(f, x0, 0.0, 1.0, 10, "midpoint").numpy())
    assert tsolvers.num_fixed_steps(1.0, 0.0, 0.02) == 50
    assert tsolvers.num_fixed_steps(0.0, 1.0, 3.0) == 1
    # the JAX default is dopri5 at rtol = atol = 1e-5, I controller
    np.testing.assert_array_equal(
        tsolvers.odeint(f, x0, 0.0, 1.0).numpy(),
        tsolvers.odeint_adaptive(f, x0, 0.0, 1.0, "dopri5").numpy())
    with pytest.raises(ValueError, match="t_mid"):
        tsolvers.odeint(f, x0, 0.0, 1.0, {"solver": "fixadp"})
    mid = tsolvers.odeint_fixed(f, x0, 0.0, 0.5, 5)
    np.testing.assert_array_equal(
        tsolvers.odeint(f, x0, 0.0, 1.0, {"solver": "fixadp",
                                          "solver_fix_step": 0.1},
                        t_mid=0.5).numpy(),
        tsolvers.odeint_adaptive(f, mid, 0.5, 1.0).numpy())
    with pytest.raises(NotImplementedError):
        tsolvers.odeint_fixed(f, x0, 0.0, 1.0, 2, method="heun")


TOY = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=64, depth=2,
           num_heads=4)


@pytest.fixture(scope="module")
def toy():
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    params = jax.jit(JaxUViT(**TOY).init)(
        jax.random.PRNGKey(1), jnp.asarray(z), jnp.zeros((2,)))
    return z, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_decode_euler8_matches_jax(toy, dtype, tol):
    """The slice end to end: noise -> U-ViT field -> Euler-8 -> latents."""
    z, params = toy
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    sk = {"solver": "fixed", "solver_fix": "euler", "solver_fix_step": 1 / 8}
    jm = JaxUViT(dtype=jdt, **TOY)
    ref = jflow.decode(lambda t, x: jm.apply(params, x, t)[0],
                       jnp.asarray(z), sk)
    tm = load_uvit_from_jax(UViT(dtype=dtype, device="cpu", **TOY), params)
    with torch.no_grad():
        out = tflow.decode(lambda t, x: tm(x, t)[0], torch.from_numpy(z), sk)
    assert out.dtype == torch.float32 and out.shape == z.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)


def test_encode_inverts_decode_with_taps(toy):
    """Reverse-time Euler with stacked capture taps, against JAX encode."""
    z, params = toy
    sk = {"solver_fix_step": 0.25}
    jm = JaxUViT(**TOY)
    ref, rtaps = jflow.encode(
        lambda t, x: jm.apply(params, x, t, capture=("mid",)),
        jnp.asarray(z), sk, has_aux=True)
    tm = load_uvit_from_jax(UViT(device="cpu", **TOY), params)
    with torch.no_grad():
        out, taps = tflow.encode(lambda t, x: tm(x, t, capture=("mid",)),
                                 torch.from_numpy(z), sk, has_aux=True)
    assert tuple(taps["mid"].shape) == rtaps["mid"].shape == (4, 2, 17, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(taps["mid"].numpy(), np.asarray(rtaps["mid"]),
                               atol=1e-4)


def test_sample_lfm_entry_point_on_cpu(toy, tmp_path, monkeypatch):
    """``run`` writes one .npy per mini-batch, named by first index, from
    JAX weights given as an .npz; it matches the JAX decode of its z."""
    from uspace_tpu_torch import configs

    z, params = toy
    cfg = configs.get_config("uvit_large")
    cfg["nnet"] = configs.uvit_nnet(**{k: v for k, v in TOY.items()
                                      if k != "img_size"}, img_size=8)
    cfg["z_shape"] = (4, 8, 8)
    cfg["compute_dtype"] = "float32"
    monkeypatch.setitem(configs.CONFIGS, "toy", cfg)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{"/".join(k): v for k, v in _flatten(params).items()})
    paths = sample_lfm.run("toy", n_samples=3, batch=2, steps=4, seed=5,
                           weights=str(npz), out=str(tmp_path / "s"),
                           device="cpu")
    assert [os.path.basename(p) for p in paths] == ["0.npy", "2.npy"]
    a, b = (np.load(p) for p in paths)
    assert a.shape == (2, 8, 8, 4) and b.shape == (1, 8, 8, 4)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # the same z through JAX
    g = torch.Generator().manual_seed(6)
    z0 = torch.randn((2, 8, 8, 4), generator=g).numpy()
    jm = JaxUViT(**TOY)
    ref = jflow.decode(lambda t, x: jm.apply(params, x, t)[0],
                       jnp.asarray(z0), {"solver": "fixed",
                                         "solver_fix": "euler",
                                         "solver_fix_step": 0.25})
    np.testing.assert_allclose(a, np.asarray(ref), atol=1e-4)
    sample_lfm.main(["--config", "toy", "--n_samples", "1", "--batch", "1",
                     "--steps", "1", "--out", str(tmp_path / "m"),
                     "--device", "cpu"])
    assert os.path.exists(tmp_path / "m" / "0.npy")


_GUARD = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "uspace_tpu"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import uspace_tpu_torch
    for m in pkgutil.walk_packages(uspace_tpu_torch.__path__,
                                   "uspace_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke
    assert not any(k.split(".")[0] in ("jax", "uspace_tpu")
                   for k in sys.modules), "jax leaked in"
    import torch
    assert not torch.cuda.is_available()
    from uspace_tpu_torch.configs import get_config
    sample_lfm = uspace_tpu_torch.cli.sample_lfm
    for call in (lambda: uspace_tpu_torch.resolve_device(),
                 lambda: uspace_tpu_torch.models.get_nnet("uvit"),
                 lambda: uspace_tpu_torch.models.get_nnet("unet_t2i"),
                 lambda: sample_lfm.build_vae(get_config("unet_large")),
                 lambda: sample_lfm.run(n_samples=1),
                 lambda: sample_lfm.run(config="unet_large", n_samples=1,
                                        decode=True),
                 lambda: uspace_tpu_torch.cli.train_lfm.run(n_steps=1)):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("default device ran without CUDA")
    print("GUARD_OK")
""")


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "GUARD_OK" in r.stdout, r.stderr[-2000:]


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: non-zero exit and no result line; alone in a directory
    without the package, too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0, r.stdout
        assert '"ok": true' not in r.stdout
