"""u-space editing: the port's ``editing`` package, the models' edit hooks,
``make_velocity_fn``, the dissection session and ``cli/dissect_lfm`` held
to the JAX package.

Both packages run one set of weights: a seeded port init carried to JAX by
the JAX package's own torch-to-Flax converters. Inputs, noise and data
come from numpy seeds; where the JAX code draws its own noise (latents from
moments), the test hands it the port's draws. Tolerances: f32 1e-6 for the
edit arithmetic, 1e-5 for the direction builders, 1e-4 of the output's
scale through a model or a solve (the same arithmetic summed in another
order); PCA components up to each one's sign, which two SVDs may choose
differently.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from uspace_tpu.codecs.convert import unet_torch_to_flax, uvit_torch_to_flax
from uspace_tpu.editing import capture as jcapture
from uspace_tpu.editing import directions as jdir
from uspace_tpu.editing import drivers as jdrivers
from uspace_tpu.editing import specs as jspecs
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.models.unet import UNet as JaxUNet
from uspace_tpu_torch.cli import dissect_lfm
from uspace_tpu_torch.cli.dissect_common import load_nnet_params
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.data.datasets import SyntheticAttrFeatures, get_dataset
from uspace_tpu_torch.data.loader import DataLoader
from uspace_tpu_torch.editing import capture as tcapture
from uspace_tpu_torch.editing import directions as tdir
from uspace_tpu_torch.editing import specs as tspecs
from uspace_tpu_torch.editing.drivers import DissectSession
from uspace_tpu_torch.models import UNet, UViT
from uspace_tpu_torch.models.unet import ZERO_INIT_STD

UVIT = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=2,
            num_heads=4, use_checkpoint=False)
UNET = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=16, use_spatial_transformer=True,
            transformer_depth=1, context_dim=24)
# each tap's activation shape without the batch: the input latents, the
# middle block's output, the velocity
TAP_SHAPES = {"uvit": {"head": (8, 8, 4), "mid": (17, 32), "tail": (8, 8, 4)},
              "unet": {"head": (16, 16, 4), "mid": (8, 8, 64),
                       "tail": (16, 16, 4)}}
SK = {"solver": "fixed", "solver_fix": "euler", "solver_fix_step": 0.25}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(out, ref, tol):
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=0,
                               atol=tol * max(float(np.abs(r).max()), 1.0))


_MODELS = {}


def _pair(kind):
    """(port model, JAX model, JAX params) of the toy U-ViT or UNet, one
    seeded port init for both (cached)."""
    if kind not in _MODELS:
        if kind == "uvit":
            m = UViT(**UVIT, device="cpu").init_weights(
                torch.Generator().manual_seed(1))
            jm, conv = JaxUViT(**UVIT), uvit_torch_to_flax
        else:
            m = UNet(**UNET, device="cpu").init_weights(
                torch.Generator().manual_seed(2), zero_init_std=ZERO_INIT_STD)
            jm, conv = JaxUNet(**UNET), unet_torch_to_flax
        _MODELS[kind] = (m.eval(), jm, {"params": conv(m.state_dict())})
    return _MODELS[kind]


def _grid(shape, n=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, *shape)).astype(np.float32)


# -- specs --------------------------------------------------------------------


def test_interp_grid_matches_jax_on_and_off_the_grid():
    """On-grid times give the exact entry (encode grids start at dt);
    off-grid times interpolate; times outside the grid take its ends."""
    g = _grid((3, 2), n=5)
    for t in (0.25, 0.5, 1.25, 0.3, 0.61, 1.0, 0.0, 2.0):
        ref = jspecs.interp_grid(jnp.asarray(g), jnp.float32(t), 0.25, 0.25)
        out = tspecs.interp_grid(torch.from_numpy(g), torch.tensor(t), 0.25,
                                 0.25)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
        if t in (0.25, 0.5, 1.25):
            assert np.array_equal(out.numpy(), g[round(t / 0.25) - 1])


def test_schedule_gate_matches_jax():
    ts = (0.0, 0.004, 0.01, 0.1, 0.2, 0.25, 0.3, 0.5, 0.6, 0.9, 1.0)
    for kw in (dict(t_edit=0.5), dict(t_edit=1.0),
               dict(t_edit=1.0, mode="every", period=0.1, grid_dt=0.01),
               dict(t_edit=1.0, mode="every", period=0.25, grid_dt=0.02)):
        ref = [float(jspecs.schedule_gate(jnp.float32(t), **kw)) for t in ts]
        out = [float(tspecs.schedule_gate(torch.tensor(t), **kw)) for t in ts]
        assert out == ref, kw
    with pytest.raises(ValueError, match="unknown schedule mode"):
        tspecs.schedule_gate(0.5, 1.0, mode="nope")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_uspace_edit_apply_matches_jax(dt):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    g = _grid((5, 3))
    x = np.random.default_rng(1).standard_normal((2, 5, 3)).astype(np.float32)
    kw = dict(grid_dt=0.25, t_edit=0.6, loc="mid")
    je = jspecs.USpaceEdit(delta_grid=jnp.asarray(g), scale=jnp.float32(0.7),
                           **kw)
    te = tspecs.USpaceEdit(delta_grid=torch.from_numpy(g), scale=0.7, **kw)
    for t in (0.0, 0.3, 0.6, 0.9):
        ref = je.apply(jnp.asarray(x, jd), jnp.float32(t))
        out = te.apply(torch.from_numpy(x).to(td), torch.tensor(t))
        assert out.dtype == td
        _close(out, ref, 1e-6 if dt == "f32" else 8e-3)
    assert te.replace(scale=0.0).apply(torch.from_numpy(x), 0.3).equal(
        torch.from_numpy(x))


# -- the models' edit hooks and taps ------------------------------------------


@pytest.mark.parametrize("kind", ["uvit", "unet"])
@pytest.mark.parametrize("loc", ["head", "mid", "tail"])
def test_edit_hooks_and_capture_match_jax(kind, loc):
    """A write edit at each tap, read back by capture at every tap, in
    both packages."""
    m, jm, params = _pair(kind)
    shape = TAP_SHAPES[kind]
    r = np.random.default_rng(3)
    x = r.standard_normal((2, *shape["head"])).astype(np.float32)
    t = np.full((2,), 0.4, np.float32)
    g = 0.5 * _grid(shape[loc], seed=4)
    taps = ("head", "mid", "tail")
    je = jspecs.USpaceEdit(delta_grid=jnp.asarray(g), scale=jnp.float32(1.5),
                           grid_dt=0.25, loc=loc)
    te = tspecs.USpaceEdit(delta_grid=torch.from_numpy(g), scale=1.5,
                           grid_dt=0.25, loc=loc)
    ref, ref_taps = jax.jit(lambda p, x, t: jm.apply(
        p, x, t, edit=je, capture=taps))(params, jnp.asarray(x),
                                         jnp.asarray(t))
    with torch.no_grad():
        out, out_taps = m(torch.from_numpy(x), torch.from_numpy(t), edit=te,
                          capture=taps)
        plain, _ = m(torch.from_numpy(x), torch.from_numpy(t))
    _close(out, ref, 1e-4)
    for k in taps:
        assert tuple(out_taps[k].shape[1:]) == shape[k]
        _close(out_taps[k], ref_taps[k], 1e-4)
    assert float((out - plain).abs().max()) > 1e-3  # the edit took effect


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_capture_trajectory_matches_jax(direction):
    m, jm, params = _pair("uvit")
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref, ref_st = jcapture.capture_trajectory(
        jm, params, jnp.asarray(x), taps=("mid", "tail"), direction=direction,
        num_steps=4)
    out, st = tcapture.capture_trajectory(
        m, torch.from_numpy(x), taps=("mid", "tail"), direction=direction,
        num_steps=4)
    _close(out, ref, 1e-4)
    assert st["mid"].shape == (4, 2, 17, 32)
    for k in ("mid", "tail"):
        _close(st[k], ref_st[k], 1e-4)
    np.testing.assert_array_equal(st["t"].numpy(), np.asarray(ref_st["t"]))
    _close(tcapture.captures_to_grid(st["mid"], st["t"]),
           jcapture.captures_to_grid(ref_st["mid"], ref_st["t"]), 1e-4)


# -- directions ---------------------------------------------------------------


def _feats():
    r = np.random.default_rng(6)
    feats = r.standard_normal((7, 3, 5, 4)).astype(np.float32)
    attrs = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0], [0, 0, 1],
                      [1, 0, 0], [0, 1, 0], [1, 1, 1]], np.float32)
    return feats, attrs


def test_attr_directions_match_jax():
    feats, attrs = _feats()
    f, a = torch.from_numpy(feats), torch.from_numpy(attrs)
    jf, ja = jnp.asarray(feats), jnp.asarray(attrs)
    _close(tdir.attr_delta(f, a[:, 0]), jdir.attr_delta(jf, ja[:, 0]), 1e-5)
    grid = tdir.attr_delta_directions(f, a)
    assert grid.shape == (3, 3, 5, 4)
    _close(grid, jdir.attr_delta_directions(jf, ja), 1e-5)
    _close(tdir.latentz_delta(f[:, 0], a), jdir.latentz_delta(jf[:, 0], ja),
           1e-5)
    for ith in (1, "0_2"):
        _close(tdir.select_direction(grid, ith),
               jdir.select_direction(jdir.attr_delta_directions(jf, ja), ith),
               1e-5)


def test_pca_matches_jax_up_to_sign():
    feats, _ = _feats()
    comps, var = tdir.pca_components(torch.from_numpy(feats[:, 0]), 3)
    jcomps, jvar = jdir.pca_components(jnp.asarray(feats[:, 0]), 3)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5)
    for c, jc in zip(comps.numpy(), np.asarray(jcomps)):
        sign = np.sign((c * jc).sum())
        np.testing.assert_allclose(sign * c, jc, rtol=0, atol=1e-5)
    grid = tdir.pca_directions(torch.from_numpy(feats), 2)
    jgrid = np.asarray(jdir.pca_directions(jnp.asarray(feats), 2))
    assert grid.shape == jgrid.shape == (3, 2, 5, 4)
    for g, jg in zip(grid.reshape(6, -1).numpy(), jgrid.reshape(6, -1)):
        np.testing.assert_allclose(np.sign((g * jg).sum()) * g, jg, rtol=0,
                                   atol=1e-5)
    assert tdir.orthogonality_error(comps) < 1e-5
    assert abs(tdir.orthogonality_error(comps)
               - jdir.orthogonality_error(jcomps)) < 1e-5


# -- the session --------------------------------------------------------------


def test_synthetic_attr_features_are_the_jax_draws():
    from uspace_tpu.data.datasets import SyntheticAttrFeatures as JaxAttr

    for raw in (False, True):
        mine, ref = SyntheticAttrFeatures(16, raw=raw), JaxAttr(16, raw=raw)
        for i in (0, 5, 15):
            for k in ("x", "attr"):
                assert np.array_equal(mine[i][k], ref[i][k])
    data = get_dataset("synthetic_attr", num=10).get_split("train")
    got = [b["x"].shape for b in DataLoader(data, 4, shuffle=False)]
    assert got == [(4, 8, 8, 8)] * 2  # the short last batch dropped
    assert len(list(DataLoader(data, 4, shuffle=False, drop_last=False))) == 3


def test_session_read_matches_jax(monkeypatch):
    """Two batches of moments: the port draws each latent's noise from its
    generator; JAX's sample_from_moments is handed the same draws."""
    m, jm, params = _pair("uvit")
    data = SyntheticAttrFeatures(num=4)
    bs = list(DataLoader(data, 2, shuffle=False))
    g = torch.Generator().manual_seed(0)
    out = DissectSession(m, solver_kwargs=SK).read(bs, generator=g)
    g = torch.Generator().manual_seed(0)
    eps = [torch.randn((2, 8, 8, 4), generator=g).numpy() for _ in bs]
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(eps.pop(0)))
    ref = jdrivers.DissectSession(jm, params, solver_kwargs=SK).read(bs)
    assert not eps
    assert out["feats"].shape == (4, 4, 17, 32)
    for k in ("latent", "feats", "t_grid"):
        _close(out[k], ref[k], 1e-4)
    np.testing.assert_array_equal(out["attr"], ref["attr"])


def test_session_write_sweep_and_roundtrip_match_jax():
    m, jm, params = _pair("uvit")
    r = np.random.default_rng(7)
    z = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    g = 0.3 * _grid((17, 32), seed=8)
    kw = dict(grid_dt=0.25, grid_t0=0.25, fixed_z=z)
    ses = DissectSession(m, solver_kwargs=SK)
    jses = jdrivers.DissectSession(jm, params, solver_kwargs=SK)
    out = ses.write_sweep(torch.from_numpy(g), (0.0, 2.0), 2, **kw)
    ref = jses.write_sweep(jnp.asarray(g), (0.0, 2.0), 2, **kw)
    assert out.shape == (2, 2, 8, 8, 4)
    _close(out, ref, 1e-4)
    assert torch.equal(out[0], ses.decode(torch.from_numpy(z)))
    errs = ses.roundtrip_error(torch.from_numpy(z))
    jerrs = jses.roundtrip_error(jnp.asarray(z))
    for k in ("abs_max", "abs_mean", "rel_mean"):
        assert errs[k] == pytest.approx(jerrs[k], rel=1e-3, abs=1e-6)


def test_write_sweep_needs_a_grid_spacing():
    """As in the JAX package, a session without solver_fix_step (an
    adaptive solver) refuses a sweep that does not give grid_dt."""
    m, _, _ = _pair("uvit")
    ses = DissectSession(m, solver_kwargs={"solver": "adaptive"})
    with pytest.raises(ValueError, match="grid_dt"):
        ses.write_sweep(torch.zeros(4, 17, 32), (0.0,), 1)


def test_load_nnet_params_reads_port_and_reference_checkpoints(tmp_path):
    """A port checkpoint's EMA weights (a file, or the latest of a
    directory) and a reference state dict load strictly; no path keeps the
    seeded weights."""
    m, _, _ = _pair("uvit")
    sd = {k: v + 1.0 for k, v in m.state_dict().items()}
    torch.save({"ema_params": sd, "params": m.state_dict()},
               tmp_path / "7.pt")
    torch.save({"ema_params": m.state_dict()}, tmp_path / "3.pt")
    torch.save(sd, tmp_path / "nnet_ema.pth")
    cfg = get_config("synthetic_smoke")
    for path in (str(tmp_path / "7.pt"), str(tmp_path / "nnet_ema.pth")):
        cfg["dissection"]["ckpt_path_to_dissect"] = path
        fresh = load_nnet_params(cfg, UViT(**UVIT, device="cpu"))
        assert all(torch.equal(fresh.state_dict()[k], v)
                   for k, v in sd.items())
    os.remove(tmp_path / "nnet_ema.pth")
    cfg["dissection"]["ckpt_path_to_dissect"] = str(tmp_path)
    fresh = load_nnet_params(cfg, UViT(**UVIT, device="cpu"))
    assert torch.equal(fresh.pos_embed, sd["pos_embed"])  # 7.pt, not 3.pt


# -- the CLI ------------------------------------------------------------------


def _png(path):
    return np.asarray(Image.open(path)).astype(int)


def test_dissect_lfm_cli_matches_jax(tmp_path):
    """read -> build_attr -> build_pca -> write_attr (on the read's
    latents) -> vis_reversible through both CLIs on the toy U-ViT with the
    same weights (a reference .pth both load) and raw attribute latents.
    The JAX side builds its directions with the functions its build modes
    call (``build_directions_npz``), which saves two session builds."""
    from uspace_tpu.cli.dissect_lfm import run as jrun
    from uspace_tpu.configs.common import base_config, d, uvit_nnet

    m, _, _ = _pair("uvit")
    pth = str(tmp_path / "nnet.pth")
    torch.save(m.state_dict(), pth)
    dis = dict(n_samples=8, mini_batch_size=8, pca_n=4,
               write_scales=(-1.0, 0.0, 1.0), ckpt_path_to_dissect=pth,
               fixed_z_path="from_read", edit_loc="mid", ith_attr=0)
    data = dict(name="synthetic_attr", num=16, shape=(8, 8, 8), num_attrs=4,
                raw=True)
    jc = base_config()
    jc.seed = 0
    jc.z_shape = (4, 8, 8)
    jc.compute_dtype = "float32"
    jc.nnet = uvit_nnet(embed_dim=32, depth=2, num_heads=4, img_size=8,
                        use_checkpoint=False)
    jc.dataset = d(**data)
    jc.train.from_moments = False
    jc.dl.num_workers = 1
    jc.dissection.update(dis, read_path_root=str(tmp_path / "jread"))
    jc.dissection.solver_kwargs.solver_fix_step = 0.25
    tc = get_config("synthetic_smoke")
    tc["dataset"] = data
    tc["train"]["from_moments"] = False
    tc["dissection"].update(dis)
    for mode in ("read", "build_attr", "build_pca", "write_attr",
                 "vis_reversible"):
        if mode.startswith("build"):
            m = mode.split("_")[1]
            jdrivers.build_directions_npz(
                str(tmp_path / "jread" / "read.npz"),
                str(tmp_path / "jread" / f"directions_{m}.npz"), mode=m,
                pca_n=4)
        else:
            jc.dissection.dissect_name = mode
            jrun(jc, str(tmp_path / "jout"))
        dissect_lfm.run(tc, mode, workdir=str(tmp_path / "tout"),
                        device="cpu", read_path_root=str(tmp_path / "tread"))
    for name in ("read", "directions_attr", "directions_pca"):
        with np.load(tmp_path / "tread" / f"{name}.npz") as a, \
                np.load(tmp_path / "jread" / f"{name}.npz") as b:
            for k in b.files:
                if k == "mode":
                    assert str(a[k]) == str(b[k])
                elif name == "directions_pca" and k == "directions":
                    x, y = a[k].reshape(16, -1), b[k].reshape(16, -1)
                    s = np.sign((x * y).sum(axis=1, keepdims=True))
                    np.testing.assert_allclose(s * x, y, rtol=0, atol=1e-4)
                else:
                    _close(a[k], b[k], 1e-4)
    png = "write_attr_sweep.png"
    a, b = _png(tmp_path / "tout" / png), _png(tmp_path / "jout" / png)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    lines = [open(tmp_path / w / "delta_change.txt").read()
             for w in ("tout", "jout")]
    nums = [[float(v) for v in re.findall(r"(?:abs|rel)_mean=([0-9.]+)", t)]
            for t in lines]
    np.testing.assert_allclose(nums[0], nums[1], rtol=1e-3, atol=2e-6)
