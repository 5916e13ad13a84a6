"""Class-conditional generation and classifier-free guidance on trained
weights (counterpart of ``uspace_tpu/cli/editing_e2e_cond.py``).

A U-ViT with a label token trained on class-keyed orthonormal latent
patterns (``data/datasets.SyntheticClassFeatures``), judged by projections
onto the planted patterns, with the JAX harness's limits:

1. **conditioning**: the generations for class y carry P_y (more than half
   the planted amplitude, a margin of 3 batch standard deviations over the
   other classes' patterns);
2. **classifier-free guidance** against the learned null class K
   (``evals.sampling.cfg_velocity_fn`` at s in {0, 1, 3}): s = 0 generates
   the class mixture (margin under half of s = 1's), s = 3 keeps at least
   0.95 of s = 1's margin.

Writes ``cond_grid.png`` and ``editing_e2e_cond.{json,md}`` into
``--workdir``. Runs on the card unless ``--device cpu``.

    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_cond_e2e \\
        --workdir cond_toy
    python -m uspace_tpu_torch.cli.editing_e2e_cond \\
        --config synthetic_cond_e2e \\
        --ckpt_path_to_dissect cond_toy/synthetic_cond_e2e/default/ckpts \\
        --workdir cond_toy/e2e
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core import flow
from ..data.datasets import SyntheticClassFeatures
from ..evals.sampling import cfg_velocity_fn
from ..train.step import make_velocity_fn
from ..utils.vis import make_grid, save_image
from .dissect_common import build_session


def harness_noise(config: dict, device) -> torch.Tensor:
    """The harness's shared noise: ``n`` (the dissection's mini-batch, at
    most 32) latents from a generator seeded with the config's seed."""
    cfg = get_config(config)
    n = min(int(cfg["dissection"]["mini_batch_size"]), 32)
    c, h, w = cfg["z_shape"]
    gen = torch.Generator(device=device).manual_seed(cfg.get("seed", 0))
    return torch.randn((n, h, w, c), generator=gen, device=device)


def run(config, workdir: str, device=None, noise=None,
        log: Callable[[str], None] = print) -> dict:
    """The checks on ``config`` (a name or a dict) with the weights of its
    ``dissection.ckpt_path_to_dissect``; writes the artefacts into
    ``workdir`` and returns the report (``passed`` is the verdict).
    ``noise`` ([n, H, W, C], numpy or tensor) replaces the harness's own
    draw (:func:`harness_noise`), e.g. with the JAX harness's."""
    cfg = get_config(config)
    d, dcfg = cfg["dissection"], cfg["dataset"]
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    session, _ = build_session(cfg, dev, cfg.get("seed", 0))
    K = int(dcfg.get("num_classes", 6))
    helper = SyntheticClassFeatures(
        num=1, shape=tuple(dcfg["shape"]), num_classes=K,
        **{k: float(dcfg[k]) for k in ("base_std", "amp", "noise_std")
           if k in dcfg})
    P = helper._pat.reshape(K, -1).astype(np.float64)
    amp = helper.amp
    z = (harness_noise(cfg, dev) if noise is None
         else torch.tensor(np.asarray(noise), dtype=torch.float32,
                           device=dev))
    n = z.shape[0]

    @torch.no_grad()
    def decode_with(vf) -> np.ndarray:
        return flow.decode(vf, z, session.solver_kwargs).float().cpu().numpy()

    def proj(lat):
        return lat.astype(np.float64).reshape(n, -1) @ P.T

    report = {"checks": {}, "n_per_setting": n}
    grids = []

    # -- check 1: conditional generation per class ---------------------------
    rows = []
    for y in range(K):
        yy = torch.full((n,), y, dtype=torch.int64, device=dev)
        lat = decode_with(make_velocity_fn(session.model, {"y": yy}))
        p = proj(lat)
        others = np.delete(p, y, axis=1)
        spread = float(others.std())
        rows.append({"class": y, "own_mean": float(p[:, y].mean()),
                     "other_mean": float(others.mean()),
                     "margin_sigma": (float(p[:, y].mean())
                                      - float(others.mean()))
                     / max(spread, 1e-9)})
        grids.append(lat)
    cond_ok = all(r["margin_sigma"] >= 3.0 and r["own_mean"] > 0.5 * amp
                  for r in rows)
    report["checks"]["conditioning"] = {"rows": rows, "passed": cond_ok}

    # -- check 2: CFG against the learned null class -------------------------
    cfg_ok = True
    if dcfg.get("cfg", False):
        y0 = 0
        yy = torch.full((n,), y0, dtype=torch.int64, device=dev)
        null_y = torch.full((n,), K, dtype=torch.int64, device=dev)
        cfg_rows = []
        for s in (0.0, 1.0, 3.0):
            lat = decode_with(cfg_velocity_fn(session.model, {"y": yy},
                                              {"y": null_y}, s))
            p = proj(lat)
            cfg_rows.append({"guidance": s,
                             "own_mean": float(p[:, y0].mean()),
                             "other_mean": float(np.delete(p, y0, 1).mean())})
            grids.append(lat)
        margins = [r["own_mean"] - r["other_mean"] for r in cfg_rows]
        cfg_ok = bool(abs(margins[0]) < 0.5 * margins[1]
                      and margins[2] >= 0.95 * margins[1] and margins[1] > 0)
        report["checks"]["cfg_guidance"] = {"rows": cfg_rows,
                                            "margins": margins,
                                            "passed": cfg_ok}
    report["passed"] = bool(cond_ok and cfg_ok)

    flat = np.concatenate(grids)[..., :3]
    img = (flat - flat.min()) / max(float(flat.max() - flat.min()), 1e-8)
    save_image(make_grid(img, nrow=n), os.path.join(workdir, "cond_grid.png"))
    with open(os.path.join(workdir, "editing_e2e_cond.json"), "w") as f:
        json.dump(report, f, indent=1)
    lines = ["# Class-conditional end-to-end verification", "",
             f"{n} samples per class, {K} classes, planted amp {amp}", "",
             "| class | own | others | margin |", "|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['class']} | {r['own_mean']:.2f} "
                     f"| {r['other_mean']:.2f} | {r['margin_sigma']:.1f}σ |")
    lines += ["", f"**{'PASS' if cond_ok else 'FAIL'}**", ""]
    if "cfg_guidance" in report["checks"]:
        cg = report["checks"]["cfg_guidance"]
        lines += ["## CFG sweep (null = learned class K)", "",
                  "| guidance | own | others | margin |", "|---|---|---|---|"]
        for r, m in zip(cg["rows"], cg["margins"]):
            lines.append(f"| {r['guidance']:g} | {r['own_mean']:.2f} "
                         f"| {r['other_mean']:.2f} | {m:.2f} |")
        lines += ["", f"**{'PASS' if cg['passed'] else 'FAIL'}**", ""]
    lines += [f"**overall: {'PASS' if report['passed'] else 'FAIL'}**", ""]
    with open(os.path.join(workdir, "editing_e2e_cond.md"), "w") as f:
        f.write("\n".join(lines))
    log(f"editing_e2e_cond: {'PASS' if report['passed'] else 'FAIL'} "
        f"(report in {workdir})")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="synthetic_cond_e2e")
    ap.add_argument("--workdir", default="e2e_cond_out")
    ap.add_argument("--ckpt_path_to_dissect", default=None,
                    help="a checkpoint of cli/train_lfm or its ckpts "
                    "directory (default: the config's)")
    ap.add_argument("--seed", type=int, default=None,
                    help="the harness's seed (default: the config's)")
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args(argv)
    cfg = get_config(a.config)
    if a.ckpt_path_to_dissect is not None:
        cfg["dissection"]["ckpt_path_to_dissect"] = a.ckpt_path_to_dissect
    if a.seed is not None:
        cfg["seed"] = a.seed
    report = run(cfg, a.workdir, a.device)
    print(json.dumps({"passed": report["passed"]}))
    return report


if __name__ == "__main__":
    main()
