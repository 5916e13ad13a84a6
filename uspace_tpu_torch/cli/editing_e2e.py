"""End-to-end editing verification on trained weights (counterpart of
``uspace_tpu/cli/editing_e2e.py``).

Runs the whole dissection workflow (read activations, build attribute and
PCA directions, write sweeps) on a checkpoint of ``cli/train_lfm`` and
checks that the u-space edit moves the attribute it was built for. The
measure needs no classifier: the projection of the generated latents onto
the attribute's own z-space direction (``editing.directions.
latentz_delta`` of the read) must move monotonically with the write scale,
by at least ``dissection.e2e_min_effect`` batch standard deviations. On the
``synthetic_attr`` dataset the planted pattern of each attribute
(``SyntheticAttrFeatures.patterns``) is a second, exact check: its
projection must move the same way.

A mean-difference direction at an interior tap is defined up to its sign
(how the decoder half uses the tap fixes the orientation in latent space),
so the harness reads the sign of each attribute's response off its sweep
(``orientation``) and judges the oriented response. Where the model's own
ground-truth response is not monotone (a tap of strong leverage saturates
at the sweep's ends), monotonicity is judged only on the scale pairs where
the ground truth moves by at least three paired standard errors
(``monotone_fraction_supported``). With ``dissection.adaptive_check`` the
write of attribute 0 at half the largest scale is repeated under a dopri5
solve and under the "fixadp" solve (fixed steps while the edit acts, dopri5
after), each against a fine fixed-step solve of the same edit: the
response ratio must lie in (0.5, 2).

Outputs into ``--workdir``: ``read.npz``, ``directions_attr.npz``,
``directions_pca.npz``, ``write_attr{a}_sweep.png``, ``roundtrip.txt``,
``editing_e2e.json`` (the JAX report's keys, and the dopri5 NFE of one
unedited decode on the trained weights, ``adaptive_decode``, and each
phase's wall ``seconds``) and ``editing_e2e.md``. Runs on the card unless
``--device cpu``.

    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_attr_e2e \\
        --workdir toy
    python -m uspace_tpu_torch.cli.editing_e2e --config synthetic_attr_e2e \\
        --workdir toy/e2e \\
        --ckpt_path_to_dissect toy/synthetic_attr_e2e/default/ckpts
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..data.datasets import SyntheticAttrFeatures, get_dataset
from ..data.loader import DataLoader
from ..editing.directions import latentz_delta, select_direction
from ..editing.drivers import DissectSession, build_directions_npz
from ..utils.vis import make_grid, save_image
from .dissect_common import build_session, decode_images

# the adaptive solves of the adaptive check and of the NFE reading: the
# reference's eval decode (dopri5, rtol = atol = 1e-5) with the I controller
_DOPRI5 = {"solver": "adaptive", "solver_adaptive": "dopri5", "rtol": 1e-5,
           "atol": 1e-5, "controller": "i"}


def _normalized(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-12)


def projection_matrix(sweep: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """[S, B] per-sample projections of [S, B, ...] latents onto a unit
    direction."""
    u = _normalized(np.asarray(direction, np.float64).ravel())
    flat = np.asarray(sweep, np.float64).reshape(sweep.shape[0],
                                                 sweep.shape[1], -1)
    return flat @ u


def projection_curve(sweep: np.ndarray, direction: np.ndarray):
    """Per-scale mean projection of [S, B, ...] latents onto a unit
    direction, and the per-sample std at each scale."""
    proj = projection_matrix(sweep, direction)
    return ([float(x) for x in proj.mean(axis=1)],
            [float(x) for x in proj.std(axis=1)])


def paired_move_sems(proj: np.ndarray):
    """Standard error of each adjacent-scale move of a [S, B] projection.

    The sweep decodes the same noise at every scale, so adjacent moves are
    paired: the noise on ``mean(proj[i+1] - proj[i])`` is the paired
    difference's SEM. One sample gives no estimate: every SEM is then
    infinite, so that no pair counts as supported."""
    b = proj.shape[1]
    if b < 2:
        return [float("inf")] * (proj.shape[0] - 1)
    d = proj[1:] - proj[:-1]
    return [float(x) for x in d.std(axis=1, ddof=1) / np.sqrt(b)]


def monotone_fraction(curve, scales, mask=None) -> float:
    """Fraction of adjacent scale pairs where the projection moves the way
    the scale does (1.0: a monotone response), counting only the pairs
    where ``mask`` (one bool a pair) is True; 1.0 when none counts."""
    ok = tot = 0
    for i in range(len(curve) - 1):
        ds = scales[i + 1] - scales[i]
        if ds == 0 or (mask is not None and not mask[i]):
            continue
        tot += 1
        ok += (curve[i + 1] - curve[i]) * ds > 0
    return ok / tot if tot else 1.0


def _attr_record(a, scales, sweep, z_delta, gt_pattern):
    """The verdict's numbers for one attribute's [S, B, ...] sweep."""
    curve, stds = projection_curve(sweep, z_delta)
    response = curve[-1] - curve[0]
    orientation = 1 if response >= 0 else -1
    oriented = [orientation * c for c in curve]
    i0 = scales.index(0.0) if 0.0 in scales else len(scales) // 2
    rec = {
        "attr": a,
        "scales": scales,
        "proj_latentz_delta": curve,
        "orientation": orientation,
        "monotone_fraction": monotone_fraction(oriented, scales),
        "response": abs(response),
        "effect_size": abs(response) / max(stds[i0], 1e-9),
    }
    if gt_pattern is None:
        return rec
    gt_curve, _ = projection_curve(sweep, gt_pattern)
    rec["proj_ground_truth"] = gt_curve
    gt_resp = gt_curve[-1] - gt_curve[0]
    gt_oriented = [orientation * c for c in gt_curve]
    rec["gt_monotone_fraction"] = monotone_fraction(gt_oriented, scales)
    rec["gt_agrees"] = bool(gt_resp * response >= 0 or gt_resp == 0)
    # judge the edit only on the scale pairs where the ground truth moves
    # monotonically by a real amount (>= 3 paired SEMs); with fewer than
    # two such pairs, on every pair
    gt_sems = paired_move_sems(projection_matrix(sweep, gt_pattern)
                               * orientation)
    gt_mono_pair = [
        (gt_oriented[i + 1] - gt_oriented[i]) * (scales[i + 1] - scales[i])
        > 0 and abs(gt_oriented[i + 1] - gt_oriented[i]) >= 3.0 * gt_sems[i]
        for i in range(len(scales) - 1)]
    rec["supported_pairs"] = int(sum(gt_mono_pair))
    rec["monotone_fraction_supported"] = (
        monotone_fraction(oriented, scales, mask=gt_mono_pair)
        if rec["supported_pairs"] >= 2
        else monotone_fraction(oriented, scales))
    return rec


def run(config, workdir: str, device=None,
        log: Callable[[str], None] = print) -> dict:
    """The workflow on ``config`` (a name or a config dict) with the
    weights of its ``dissection.ckpt_path_to_dissect``; writes the
    artefacts into ``workdir`` and returns the report (its ``passed`` is
    the verdict). The config's ``seed`` seeds the read's latents and the
    sweeps' noise."""
    cfg = get_config(config)
    d = cfg["dissection"]
    dev = resolve_device(device)
    seed = cfg.get("seed", 0)
    os.makedirs(workdir, exist_ok=True)
    secs = {}
    t0 = time.perf_counter()
    session, vae_decode = build_session(cfg, dev, seed)
    c, h, w = cfg["z_shape"]
    z_hwc = (h, w, c)
    scales = [float(s) for s in d["write_scales"]]
    edit_loc = d.get("edit_loc") or "mid"

    def gen():  # the same noise for every sweep, as the JAX harness's rng
        return torch.Generator(device=dev).manual_seed(seed)

    # -- step 1: read (encode the data, capture the tap) ---------------------
    read_path = os.path.join(workdir, "read.npz")
    if not os.path.exists(read_path):
        data = get_dataset(**cfg["dataset"]).get_split("train")
        out = session.read(
            DataLoader(data, d["mini_batch_size"], shuffle=False),
            tap=edit_loc, max_samples=d["n_samples"], generator=gen(),
            from_moments=cfg["train"].get("from_moments", True))
        np.savez(read_path, **out)
        log(f"read: feats {out['feats'].shape} -> {read_path}")
    data = dict(np.load(read_path))
    if "attr" not in data:
        raise ValueError("editing_e2e needs an attributed dataset "
                         "(read.npz has no 'attr')")
    num_attrs = data["attr"].shape[1]
    secs["read"] = time.perf_counter() - t0

    # -- step 2: directions (attr and pca) -----------------------------------
    t0 = time.perf_counter()
    attr_npz = build_directions_npz(
        read_path, os.path.join(workdir, "directions_attr.npz"), mode="attr",
        device=dev)
    build_directions_npz(read_path,
                         os.path.join(workdir, "directions_pca.npz"),
                         mode="pca", pca_n=min(int(d["pca_n"]), 8),
                         device=dev)
    with np.load(attr_npz) as dirs:
        grid_all = torch.as_tensor(dirs["directions"])  # [T, A, ...]
        t_grid = dirs["t_grid"]
    grid_t0 = float(t_grid[0])
    # the delta grid's spacing is the read's, whatever solver writes
    grid_dt = float(t_grid[1] - t_grid[0]) if len(t_grid) > 1 else 0.01
    z_deltas = latentz_delta(torch.as_tensor(data["latent"]),
                             torch.as_tensor(data["attr"])).numpy()
    gt_patterns = None
    if cfg["dataset"].get("name") == "synthetic_attr":
        gt_patterns = SyntheticAttrFeatures.patterns(
            z_hwc, int(cfg["dataset"].get("num_attrs", 4)))
    secs["directions"] = time.perf_counter() - t0

    # -- step 3: write sweeps and the proxy measure --------------------------
    t0 = time.perf_counter()
    n = min(int(d["n_samples"]), int(d["mini_batch_size"]), 16)
    sweep_kw = dict(grid_dt=grid_dt, grid_t0=grid_t0, loc=edit_loc,
                    z_shape=z_hwc)
    results = []
    for a in range(num_attrs):
        sweep = session.write_sweep(
            select_direction(grid_all, a), scales, n,
            t_edit=float(d["t_edit"]), generator=gen(), **sweep_kw)
        sweep = sweep.float().cpu().numpy()  # [S, B, ...]
        results.append(_attr_record(
            a, scales, sweep, z_deltas[a],
            None if gt_patterns is None else gt_patterns[a]))
        img = decode_images(vae_decode, sweep.reshape(-1, *sweep.shape[2:]),
                            int(d["mini_batch_size"]))
        save_image(make_grid(img, nrow=n),
                   os.path.join(workdir, f"write_attr{a}_sweep.png"))
    secs["write"] = time.perf_counter() - t0

    # -- step 3b: attribute 0's write under adaptive and fixadp solves -------
    # against a fine fixed-step solve of the same edit (the continuous limit
    # an adaptive stepper integrates), at half the largest scale, where a
    # tap of strong leverage has not saturated
    t0 = time.perf_counter()
    adaptive_checks = []
    if d.get("adaptive_check"):
        base_sk = dict(d["solver_kwargs"])
        s_adapt = scales[-1] * 0.5
        end_scales = [-s_adapt, 0.0, s_adapt]
        fine_step = min(0.02, float(base_sk.get("solver_fix_step", 0.01)))
        direction = select_direction(grid_all, 0)

        def response(sk, stats=None):
            sw = DissectSession(session.model, solver_kwargs=sk).write_sweep(
                direction, end_scales, n, t_edit=0.5, generator=gen(),
                stats=stats, **sweep_kw)
            curve, _ = projection_curve(sw.float().cpu().numpy(),
                                        z_deltas[0])
            return curve, curve[-1] - curve[0]

        _, ref_resp = response({**base_sk, "solver": "fixed",
                                "solver_fix_step": fine_step})
        for solver_name, sk in (
                ("adaptive", dict(_DOPRI5)),
                ("fixadp", {**base_sk, **_DOPRI5, "solver": "fixadp",
                            "solver_fix_step": fine_step})):
            stats = []
            curve2, resp2 = response(sk, stats)
            ratio = float(resp2 / ref_resp) if ref_resp else 0.0
            adaptive_checks.append({
                "solver": solver_name,
                "proj_latentz_delta": curve2,
                "response_vs_fixed": ratio,
                "agrees": bool(resp2 * ref_resp > 0 and 0.5 < abs(
                    resp2 / max(abs(ref_resp), 1e-9)) < 2.0),
                "nfe": [int(st["nfe"]) for st in stats],
            })
            log(f"adaptive_check {solver_name}: response ratio {ratio:.3f}, "
                f"NFE {adaptive_checks[-1]['nfe']}")
    secs["adaptive_check"] = time.perf_counter() - t0

    # -- the dopri5 NFE of an unedited decode on the trained weights ---------
    t0 = time.perf_counter()
    st = {}
    z = torch.randn((n, *z_hwc), generator=gen(), device=dev)
    DissectSession(session.model, solver_kwargs=_DOPRI5).decode(z, stats=st)
    adaptive_decode = {k: int(st[k]) for k in ("nfe", "steps", "accepted")}
    log(f"dopri5 decode of {n} samples: {adaptive_decode}")
    secs["adaptive_decode"] = time.perf_counter() - t0

    # -- step 4: roundtrip (encode -> decode) --------------------------------
    t0 = time.perf_counter()
    errs = session.roundtrip_error(torch.as_tensor(data["latent"][:n],
                                                   device=dev))
    with open(os.path.join(workdir, "roundtrip.txt"), "w") as f:
        f.write(f"solver={session.solver_kwargs} "
                f"abs_mean={errs['abs_mean']:.6f} "
                f"rel_mean={errs['rel_mean']:.6f}\n")
    secs["roundtrip"] = time.perf_counter() - t0

    # -- verdict -------------------------------------------------------------
    min_effect = float(d.get("e2e_min_effect", 1.0) or 1.0)

    def attr_ok(r):
        mono = r.get("monotone_fraction_supported", r["monotone_fraction"])
        return (mono >= 0.9 and r["effect_size"] >= min_effect
                and r.get("gt_agrees", True))

    passed = all(attr_ok(r) for r in results) and all(
        c["agrees"] for c in adaptive_checks)
    report = {
        "config": cfg["dataset"].get("name"),
        "nnet": cfg["nnet"].get("name"),
        "n_read": int(data["latent"].shape[0]),
        "edit_loc": edit_loc,
        "roundtrip": {k: float(v) for k, v in errs.items()},
        "attrs": results,
        "adaptive_checks": adaptive_checks,
        "adaptive_decode": adaptive_decode,
        "seconds": secs,
        "passed": bool(passed),
    }
    with open(os.path.join(workdir, "editing_e2e.json"), "w") as f:
        json.dump(report, f, indent=1)

    lines = [
        "# End-to-end editing verification", "",
        f"dataset `{report['config']}`, {report['n_read']} read samples, "
        f"edit_loc `{edit_loc}`, roundtrip rel err "
        f"{report['roundtrip']['rel_mean']:.4f}", "",
        "| attr | " + " | ".join(f"s={s:g}" for s in scales)
        + " | orient | monotone | effect | verdict |",
        "|---|" + "---|" * (len(scales) + 4),
    ]
    for r in results:
        row = " | ".join(f"{p:.2f}" for p in r["proj_latentz_delta"])
        mono = r.get("monotone_fraction_supported", r["monotone_fraction"])
        lines.append(f"| {r['attr']} | {row} | {r['orientation']:+d} "
                     f"| {mono:.2f} | {r['effect_size']:.1f}σ "
                     f"| {'PASS' if attr_ok(r) else 'FAIL'} |")
    if adaptive_checks:
        lines += ["", "adaptive-solver writes (interp_grid at off-grid t; "
                      "response ratio vs the fixed-step write, same edit):",
                  ""]
        for c in adaptive_checks:
            lines.append(f"- `{c['solver']}`: ratio "
                         f"{c['response_vs_fixed']:.3f} (NFE {c['nfe']}) — "
                         f"{'PASS' if c['agrees'] else 'FAIL'}")
    lines += ["", f"dopri5 (rtol = atol = 1e-5) decode of {n} samples: NFE "
                  f"{adaptive_decode['nfe']}, {adaptive_decode['accepted']} "
                  f"of {adaptive_decode['steps']} steps accepted",
              "", f"**overall: {'PASS' if passed else 'FAIL'}**", ""]
    with open(os.path.join(workdir, "editing_e2e.md"), "w") as f:
        f.write("\n".join(lines))
    log(f"editing_e2e: {'PASS' if passed else 'FAIL'} (report in "
        f"{workdir})")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--workdir", default="e2e_out")
    ap.add_argument("--ckpt_path_to_dissect", default=None,
                    help="a checkpoint of cli/train_lfm or its ckpts "
                    "directory (default: the config's)")
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args(argv)
    cfg = get_config(a.config)
    if a.ckpt_path_to_dissect is not None:
        cfg["dissection"]["ckpt_path_to_dissect"] = a.ckpt_path_to_dissect
    report = run(cfg, a.workdir, a.device)
    print(json.dumps({"passed": report["passed"],
                      "roundtrip": report["roundtrip"],
                      "adaptive_decode": report["adaptive_decode"]}))
    return report


if __name__ == "__main__":
    main()
