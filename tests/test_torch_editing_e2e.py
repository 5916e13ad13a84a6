"""``cli/editing_e2e`` of the port held to ``uspace_tpu/cli/editing_e2e.py``:
its measures against JAX's on the same seeded arrays (f64 arithmetic both
sides, 1e-6), and a CPU run of the whole harness on briefly trained toys,
which checks its plumbing (every artefact, the JAX report's keys), not its
verdict. The proof on trained weights runs on the card through the entry
points (``docs/editing_e2e_torch.md``); the JAX package's CPU proof bar is
kept here as a ``slow`` test, outside Tier-1.
"""

import json
import os

import numpy as np
import pytest
import torch

from uspace_tpu.cli import editing_e2e as jax_e2e
from uspace_tpu_torch.cli import editing_e2e, train_lfm
from uspace_tpu_torch.configs import get_config

# the keys of uspace_tpu/cli/editing_e2e.py's report (run, :341-350), of an
# attribute's record (:194-239) and of an adaptive check (:306-313)
REPORT_KEYS = {"config", "nnet", "n_read", "edit_loc", "roundtrip", "attrs",
               "adaptive_checks", "passed"}
ATTR_KEYS = {"attr", "scales", "proj_latentz_delta", "orientation",
             "monotone_fraction", "response", "effect_size",
             "proj_ground_truth", "gt_monotone_fraction", "gt_agrees",
             "supported_pairs", "monotone_fraction_supported"}
CHECK_KEYS = {"solver", "proj_latentz_delta", "response_vs_fixed", "agrees"}


@pytest.fixture(autouse=True)
def one_thread():
    """The toys' ops are small: one intra-op thread runs them as fast and
    keeps them from spinning against other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_measures_are_the_jax_measures():
    rng = np.random.default_rng(0)
    sweep = rng.standard_normal((5, 6, 8, 8, 4)).astype(np.float32)
    sweep += np.linspace(-2, 2, 5)[:, None, None, None, None]
    direction = rng.standard_normal((8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        editing_e2e.projection_matrix(sweep, direction),
        jax_e2e.projection_matrix(sweep, direction), rtol=1e-6, atol=1e-6)
    for mine, ref in zip(editing_e2e.projection_curve(sweep, direction),
                         jax_e2e.projection_curve(sweep, direction)):
        np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-6)
    proj = jax_e2e.projection_matrix(sweep, direction)
    for p in (proj, proj[:, :1]):  # one sample: no paired estimate
        np.testing.assert_allclose(editing_e2e.paired_move_sems(p),
                                   jax_e2e.paired_move_sems(p), rtol=1e-6)
    scales = [-2.0, -1.0, 0.0, 1.0, 2.0]
    for curve in ([0.1, 0.3, 0.2, 0.5, 0.9], [1.0, 0.5, 0.6, 0.1, -1.0],
                  [0.0] * 5):
        for mask in (None, [True, False, True, True], [False] * 4):
            assert editing_e2e.monotone_fraction(curve, scales, mask) == \
                jax_e2e.monotone_fraction(curve, scales, mask)


def _toy(name, tmp_path, steps=3):
    """A toy config trained ``steps`` steps at batch 16 in f32 on the CPU,
    its harness cut to 16 read samples, three scales and 4 Euler steps."""
    cfg = get_config(name)
    cfg["compute_dtype"] = "float32"
    cfg["train"]["batch_size"] = 16
    train_lfm.run(cfg, n_steps=steps, device="cpu",
                  workdir=str(tmp_path / "train"), log=lambda s: None)
    d = cfg["dissection"]
    scales = d["write_scales"]
    d.update(n_samples=16, mini_batch_size=16,
             write_scales=(scales[0], 0, scales[-1]),
             ckpt_path_to_dissect=str(tmp_path / "train" / "ckpts"))
    d["solver_kwargs"]["solver_fix_step"] = 0.25
    return cfg


@pytest.mark.parametrize("name", ["synthetic_attr_e2e",
                                  "synthetic_attr_unet_e2e"])
def test_harness_writes_every_artefact(tmp_path, name):
    """The U-ViT toy and the UNet toy (with its adaptive and fixadp
    check): every artefact of the JAX harness, a report with its keys (and
    the dopri5 NFE and phase times beside them), finite numbers."""
    cfg = _toy(name, tmp_path)
    out = tmp_path / "e2e"
    report = editing_e2e.run(cfg, str(out), device="cpu", log=lambda s: None)
    files = {"read.npz", "directions_attr.npz", "directions_pca.npz",
             "roundtrip.txt", "editing_e2e.json", "editing_e2e.md"}
    files |= {f"write_attr{a}_sweep.png" for a in range(4)}
    assert files <= set(os.listdir(out))
    with open(out / "editing_e2e.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) - {"adaptive_decode", "seconds"} == REPORT_KEYS
    assert report["n_read"] == 16 and len(report["attrs"]) == 4
    for rec in report["attrs"]:
        assert set(rec) == ATTR_KEYS
        assert np.isfinite(rec["proj_latentz_delta"]).all()
        assert np.isfinite(rec["effect_size"])
    checks = report["adaptive_checks"]
    assert [c["solver"] for c in checks] == (
        ["adaptive", "fixadp"] if name.endswith("unet_e2e") else [])
    for c in checks:
        assert set(c) - {"nfe"} == CHECK_KEYS and len(c["nfe"]) == 3
        assert min(c["nfe"]) > 0
    assert report["adaptive_decode"]["nfe"] > 0
    assert np.isfinite(list(report["roundtrip"].values())).all()
    assert "overall" in (out / "editing_e2e.md").read_text()


@pytest.mark.slow
def test_trained_model_editing_end_to_end(tmp_path):
    """The JAX package's CPU proof bar (tests/test_editing_e2e.py:55-112):
    a U-ViT of embed 64, depth 4, two attributes, 800 steps at batch 64 in
    f32 with EMA 0.99, then the harness on 96 read samples, five scales and
    Euler steps of 0.1: every attribute monotone (>= 0.9), an effect of at
    least half a batch std, the planted pattern agreeing, and the roundtrip
    closing."""
    cfg = get_config("synthetic_attr_e2e")
    cfg["compute_dtype"] = "float32"
    cfg["train"].update(ema_rate=0.99, n_steps=800, batch_size=64,
                        log_interval=200)
    cfg["nnet"].update(embed_dim=64, depth=4)
    cfg["dataset"].update(num=1024, num_attrs=2)
    cfg["dissection"].update(n_samples=96, mini_batch_size=48,
                             write_scales=(-150.0, -75.0, 0.0, 75.0, 150.0),
                             e2e_min_effect=0.5)
    cfg["dissection"]["solver_kwargs"]["solver_fix_step"] = 0.1
    train_lfm.run(cfg, device="cpu", workdir=str(tmp_path / "train"),
                  log=lambda s: None)
    cfg["dissection"]["ckpt_path_to_dissect"] = str(tmp_path / "train" /
                                                    "ckpts")
    report = editing_e2e.run(cfg, str(tmp_path / "e2e"), device="cpu")
    for rec in report["attrs"]:
        assert rec["effect_size"] >= 0.5, rec
        assert rec["monotone_fraction"] >= 0.9, rec
        assert rec["gt_agrees"], rec
    assert report["passed"]
    assert report["roundtrip"]["rel_mean"] < 0.5
    assert (tmp_path / "e2e" / "write_attr0_sweep.png").exists()
    assert (tmp_path / "e2e" / "directions_pca.npz").exists()
