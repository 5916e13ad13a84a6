"""T2I conditioning and prompt-to-prompt editing on trained weights
(counterpart of ``uspace_tpu/cli/editing_e2e_t2i.py``).

The reference's ``dissect_lfm_t2i.py`` repertoire against a T2I model
trained on caption-structured synthetic data
(``data/datasets.SyntheticT2IFeatures``), judged by projections onto the
planted word patterns P_w with the JAX harness's limits:

1. **conditioning**: generations from the context of words (w1, w2) carry
   P_w1 and P_w2 (more than half the planted amplitude, a margin of 3 batch
   standard deviations over the absent words);
2. **p2p rescale** (U-ViT-T2I only: the SD-UNet's cross-attention has no
   joint token axis): w1's context column multiplied by 0, 0.5, 1, 1.5, 2
   moves P_w1 monotonically, suppression (0 against 1) cuts it by more than
   a quarter of the amplitude and moves P_w2 by less than half that cut;
3. **local-prompt rewrite**: w1's embedding swapped for w3's moves the
   generation from P_w1 to P_w3 by more than half the amplitude each way,
   P_w2 by less;
4. **classifier-free guidance** (a model trained with context dropout): s
   in {0, 1, 3} against the zeros context; s = 0 erases the caption's
   margin (under half of s = 1's), s = 3 keeps at least 0.95 of it.

Every decode is one solve of the session from the same noise; the edited
ones run the plain attention in every block (``models/uvit_t2i.py``).
Writes ``t2i_sweeps.png`` and ``editing_e2e_t2i.{json,md}`` into
``--workdir``. Runs on the card unless ``--device cpu``.

    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_t2i_e2e \\
        --workdir t2i_toy
    python -m uspace_tpu_torch.cli.editing_e2e_t2i \\
        --config synthetic_t2i_e2e \\
        --ckpt_path_to_dissect t2i_toy/synthetic_t2i_e2e/default/ckpts \\
        --workdir t2i_toy/e2e
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
from ..data.datasets import SyntheticT2IFeatures
from ..editing.specs import AttnEdit, p2p_col_mult
from ..evals.sampling import cfg_velocity_fn
from ..utils.vis import make_grid, save_image
from .dissect_common import build_session
from .editing_e2e_cond import harness_noise


def _projections(lat: np.ndarray, patterns: np.ndarray) -> np.ndarray:
    """[B, ...] latents x [V, ...] unit patterns -> [B, V]."""
    flat = np.asarray(lat, np.float64).reshape(lat.shape[0], -1)
    p = np.asarray(patterns, np.float64).reshape(patterns.shape[0], -1)
    return flat @ p.T


def run(config, workdir: str, device=None, noise=None,
        log: Callable[[str], None] = print) -> dict:
    """The checks on ``config`` (a name or a dict) with the weights of its
    ``dissection.ckpt_path_to_dissect``; writes the artefacts into
    ``workdir`` and returns the report (``passed`` is the verdict).
    ``noise`` replaces the harness's own draw (``editing_e2e_cond.
    harness_noise``), e.g. with the JAX harness's."""
    cfg = get_config(config)
    d, dcfg, nnet = cfg["dissection"], cfg["dataset"], cfg["nnet"]
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    session, _ = build_session(cfg, dev, cfg.get("seed", 0))
    vocab = int(dcfg.get("vocab", 6))
    num_tokens = int(dcfg.get("num_tokens", 8))
    ctx_dim = int(dcfg.get("ctx_dim", 32))
    helper = SyntheticT2IFeatures(
        num=1, shape=tuple(dcfg["shape"]), vocab=vocab,
        num_tokens=num_tokens, ctx_dim=ctx_dim,
        **{k: float(dcfg[k]) for k in ("base_std", "amp", "noise_std",
                                       "ctx_scale") if k in dcfg})
    P = helper._pat
    amp = helper.amp
    z = (harness_noise(cfg, dev) if noise is None
         else torch.tensor(np.asarray(noise), dtype=torch.float32,
                           device=dev))
    n = z.shape[0]
    # the p2p check needs the joint-attention layout [time, ctx, patches];
    # the SD-UNet conditions by cross-attention and takes checks 1, 3, 4
    has_joint_attn = nnet["name"] == "uvit_t2i"
    if has_joint_attn:
        seq_len = 1 + num_tokens + (cfg["z_shape"][1]
                                    // int(nnet["patch_size"])) ** 2

    def context(ctx_row) -> torch.Tensor:
        return torch.as_tensor(ctx_row, device=dev)[None].expand(
            n, num_tokens, ctx_dim).contiguous()

    def gen(ctx_row, attn_edit=None) -> np.ndarray:
        out = session.decode(z, cond={"context": context(ctx_row)},
                             attn_edit=attn_edit)
        return out.float().cpu().numpy()

    report = {"checks": {}}
    grids = []

    # -- check 1: conditioning ------------------------------------------------
    if vocab < 4:
        raise ValueError("the verification protocol needs >= 4 words")
    pairs = [(0, 1), (2, 3), (1, 2), (0, vocab - 1)]
    cond_rows, base_lat = [], {}
    for (a, b) in pairs:
        lat = gen(helper.context_of(a, b))
        base_lat[(a, b)] = lat
        proj = _projections(lat, P)
        absent_ids = [w for w in range(vocab) if w not in (a, b)]
        present = float(proj[:, [a, b]].mean())
        absent = float(proj[:, absent_ids].mean())
        spread = float(proj[:, absent_ids].std())
        cond_rows.append({"pair": [a, b], "present_mean": present,
                          "absent_mean": absent,
                          "margin_sigma": (present - absent)
                          / max(spread, 1e-9)})
        grids.append(lat)
    cond_ok = all(r["margin_sigma"] >= 3.0 and r["present_mean"] > 0.5 * amp
                  for r in cond_rows)
    report["checks"]["conditioning"] = {"rows": cond_rows, "passed": cond_ok}

    # -- check 2: p2p column rescale on w1's token ---------------------------
    a, b = pairs[0]
    p2p_ok = True
    if has_joint_attn:
        mults = [0.0, 0.5, 1.0, 1.5, 2.0]
        p2p_rows = []
        for m in mults:
            cols = p2p_col_mult(n, seq_len, np.full((n, 1), 1, np.int32), m,
                                device=dev)
            lat = gen(helper.context_of(a, b), attn_edit=AttnEdit(cols))
            proj = _projections(lat, P)
            p2p_rows.append({"mult": m,
                             "proj_target": float(proj[:, a].mean()),
                             "proj_other": float(proj[:, b].mean())})
            grids.append(lat)
        t_curve = [r["proj_target"] for r in p2p_rows]
        o_curve = [r["proj_other"] for r in p2p_rows]
        t_span = t_curve[-1] - t_curve[0]
        monotone = all((t_curve[i + 1] - t_curve[i]) * t_span >= 0
                       for i in range(len(t_curve) - 1))
        # suppressing the token (mult 0) must cut the word's content against
        # the baseline (mult 1) far more than it moves the untouched word
        i1 = mults.index(1.0)
        target_drop = t_curve[i1] - t_curve[0]
        other_drift = abs(o_curve[i1] - o_curve[0])
        p2p_ok = bool(monotone and target_drop > 0.25 * amp
                      and other_drift < 0.5 * target_drop)
        report["checks"]["p2p_rescale"] = {
            "word": a, "rows": p2p_rows, "monotone": monotone,
            "target_drop_mult0": target_drop,
            "other_drift_mult0": other_drift, "passed": p2p_ok}
    else:
        report["checks"]["p2p_rescale"] = {
            "skipped": True,
            "reason": "cross-attention family: joint-attention token "
                      "rescale does not apply"}

    # -- check 3: local-prompt rewrite (w1 -> w3) ----------------------------
    c = pairs[1][0]  # a word absent from (a, b)
    lat_new = gen(helper.context_of(c, b))
    po, pn = _projections(base_lat[(a, b)], P), _projections(lat_new, P)
    lp = {"from_word": a, "to_word": c, "kept_word": b,
          "old_word_before": float(po[:, a].mean()),
          "old_word_after": float(pn[:, a].mean()),
          "new_word_before": float(po[:, c].mean()),
          "new_word_after": float(pn[:, c].mean()),
          "kept_word_before": float(po[:, b].mean()),
          "kept_word_after": float(pn[:, b].mean())}
    lp_ok = bool(
        lp["new_word_after"] - lp["new_word_before"] > 0.5 * amp
        and lp["old_word_before"] - lp["old_word_after"] > 0.5 * amp
        and abs(lp["kept_word_after"] - lp["kept_word_before"]) < 0.5 * amp)
    lp["passed"] = lp_ok
    report["checks"]["local_prompt"] = lp
    grids.append(lat_new)

    # -- check 4: classifier-free guidance (cfg-trained models only) ---------
    cfg_ok = True
    if dcfg.get("cfg", False):
        ctx_full = context(helper.context_of(a, b))
        null_ctx = torch.zeros_like(ctx_full)
        absent_ids = [w for w in range(vocab) if w not in (a, b)]
        cfg_rows = []
        for s in (0.0, 1.0, 3.0):
            vf = cfg_velocity_fn(session.model, {"context": ctx_full},
                                 {"context": null_ctx}, s)
            with torch.no_grad():
                lat = flow.decode(vf, z, session.solver_kwargs)
            lat = lat.float().cpu().numpy()
            proj = _projections(lat, P)
            cfg_rows.append({"guidance": s,
                             "present_mean": float(proj[:, [a, b]].mean()),
                             "absent_mean": float(proj[:, absent_ids].mean())})
            grids.append(lat)
        margins = [r["present_mean"] - r["absent_mean"] for r in cfg_rows]
        # s = 0 is unconditional, s = 1 the conditional model, s > 1
        # amplified guidance
        cfg_ok = bool(abs(margins[0]) < 0.5 * margins[1]
                      and margins[2] >= 0.95 * margins[1]
                      and margins[1] > 0)
        report["checks"]["cfg_guidance"] = {"rows": cfg_rows,
                                            "margins": margins,
                                            "passed": cfg_ok}

    passed = cond_ok and p2p_ok and lp_ok and cfg_ok
    report["passed"] = bool(passed)
    report["n_per_setting"] = n

    flat = np.concatenate(grids)[:, :, :, :3]
    img = (flat - flat.min()) / max(float(flat.max() - flat.min()), 1e-8)
    save_image(make_grid(img, nrow=n), os.path.join(workdir, "t2i_sweeps.png"))
    with open(os.path.join(workdir, "editing_e2e_t2i.json"), "w") as f:
        json.dump(report, f, indent=1)
    lines = ["# T2I end-to-end verification", "",
             f"{n} samples per setting, vocab {vocab}, planted amp {amp}", "",
             "## 1. conditioning (present vs absent pattern projections)", "",
             "| pair | present | absent | margin |", "|---|---|---|---|"]
    for r in cond_rows:
        lines.append(f"| {tuple(r['pair'])} | {r['present_mean']:.2f} "
                     f"| {r['absent_mean']:.2f} | {r['margin_sigma']:.1f}σ |")
    lines += ["", f"**{'PASS' if cond_ok else 'FAIL'}**", ""]
    if has_joint_attn:
        lines += [f"## 2. p2p rescale of word {a}'s token", "",
                  "| mult | proj(word) | proj(other) |", "|---|---|---|"]
        for r in p2p_rows:
            lines.append(f"| {r['mult']:g} | {r['proj_target']:.2f} "
                         f"| {r['proj_other']:.2f} |")
        lines += ["", f"monotone={monotone}, drop@0={target_drop:.2f}, "
                  f"other drift={other_drift:.2f} — "
                  f"**{'PASS' if p2p_ok else 'FAIL'}**", ""]
    else:
        lines += ["## 2. p2p rescale — n/a (cross-attention family; "
                  "joint-attention token rescale does not apply)", ""]
    lines += [f"## 3. local-prompt rewrite {a}→{c} (keep {b})", "",
              f"word {a}: {lp['old_word_before']:.2f} → "
              f"{lp['old_word_after']:.2f}; "
              f"word {c}: {lp['new_word_before']:.2f} → "
              f"{lp['new_word_after']:.2f}; "
              f"word {b}: {lp['kept_word_before']:.2f} → "
              f"{lp['kept_word_after']:.2f} — "
              f"**{'PASS' if lp_ok else 'FAIL'}**", ""]
    if "cfg_guidance" in report["checks"]:
        cg = report["checks"]["cfg_guidance"]
        lines += ["## 4. classifier-free guidance sweep", "",
                  "| guidance | present | absent | margin |",
                  "|---|---|---|---|"]
        for r, m in zip(cg["rows"], cg["margins"]):
            lines.append(f"| {r['guidance']:g} | {r['present_mean']:.2f} "
                         f"| {r['absent_mean']:.2f} | {m:.2f} |")
        lines += ["", f"**{'PASS' if cg['passed'] else 'FAIL'}**", ""]
    lines += [f"**overall: {'PASS' if passed else 'FAIL'}**", ""]
    with open(os.path.join(workdir, "editing_e2e_t2i.md"), "w") as f:
        f.write("\n".join(lines))
    log(f"editing_e2e_t2i: {'PASS' if passed else 'FAIL'} (report in "
        f"{workdir})")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="synthetic_t2i_e2e")
    ap.add_argument("--workdir", default="e2e_t2i_out")
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
