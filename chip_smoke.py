#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uspace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. the card: `nvidia-smi` name and power limit, TF32 off for comparisons;
2. build every CUDA kernel from the sources in this checkout (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin at its path's shapes
   (B=50 for the sampling kernels, B=128 for the backward kernel; L=257,
   C=1024, H=16, bf16): max-abs and rel-L2 within the tolerances below;
   kernel, twin and library-call times with CUDA events; the bound of the
   same work on an H100 SXM;
4. the main path: U-ViT-large (embed 1024, depth 20, 16 heads, patch 2) in
   bf16 with seeded random weights, Euler-50 at batch 50 through
   `core.flow.decode` with attn_impl="auto": 21 x 50 = 1050 launches of the
   QKV-projection kernel, latents against the plain path (attn_impl="xla")
   from the same z, img/s of both, peak memory;
5. the "pallas_packed" and "pallas_lnmlp" views for a few Euler steps, their
   launch counts and agreement with the plain path;
6. the entry point `cli.sample_lfm.run` writing two latent batches;
7. the training path: U-ViT-large with f32 master weights and bf16 compute,
   attn_impl="pallas_packed", per-block remat with REMAT_EXEMPT blocks
   exempt, batch 128 of `SyntheticFeatures` moments, the JAX bench's Adam
   (betas 0.99, L2 0.03), warmup schedule and EMA 0.995, through
   `train.step.make_train_step`: train img/s, peak memory, every loss
   finite, no non-finite skip, and exact launch counts per step (packed
   attention 21 + rematted blocks, its backward 21);
8. gradient agreement at batch 32 on one batch: the kernel path
   (pallas_packed) against the plain path (xla attention), and the `auto`
   view (QKV-projection kernel + backward) against pallas_packed;
9. the entry point `cli.train_lfm.run` for 2 steps; its checkpoint's params
   load into a fresh model with strict=True.

Prints the `kernels` JSON line and then, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With `--out PATH` the whole report is also written to PATH as JSON.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain twin on the same inputs: the two share every rounding
# site, so they differ only where an f32 sum taken in another order flips
# a bf16 rounding (one bf16 ulp of an O(1) value is 4e-3 to 8e-3);
# measured on an H100 at the main path's shapes: max-abs <= 2e-3,
# rel-L2 <= 5e-4
KERNEL_MAX_ABS = 1e-2
KERNEL_REL_L2 = 2e-3
# the backward kernel vs its twin at B=128 (same reasoning: shared rounding
# sites, bf16 flips where an f32 sum runs in another order); measured on an
# H100: max-abs 9.8e-4 (one bf16 ulp), rel-L2 8.2e-5
BWD_MAX_ABS = 5e-3
BWD_REL_L2 = 5e-4
# a whole solve, fused kernels vs plain attention: the kernels normalise
# after P.V (the plain softmax before), so bf16 roundings differ in every
# attention call; measured on an H100: cos >= 0.9999982, rel-L2 <= 1.9e-3
PATH_MIN_COS = 0.9999
PATH_MAX_REL_L2 = 1e-2

# H100 SXM published peaks (dense bf16, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# global gradient at batch 32, kernel path vs plain path and auto vs
# pallas_packed: bf16 roundings differ in every attention call, forward and
# backward; measured on an H100: pallas_packed vs xla cos 0.9999986, rel-L2
# 1.7e-3 (auto vs pallas_packed: identical)
GRAD_MIN_COS = 0.99999
GRAD_MAX_REL_L2 = 1e-2

B, L, C, H = 50, 257, 1024, 16
STEPS = 50
SHORT_STEPS = 4
TRAIN_B = 128          # the reference's per-GPU batch
# blocks left un-rematted at TRAIN_B: all 21 fit (47.5 GiB peak) and run
# fastest (profile_field --train on an H100: 121.0 img/s, against 103.1 at
# 12 and 90.8 at 0); phase 8 runs the rematted path (remat_exempt 0)
REMAT_EXEMPT = 21
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
GRAD_B = 32


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, out, ref):
    a, b = out.double(), ref.double()
    if not torch.isfinite(a).all():
        return float("inf"), float("inf"), float("-inf")
    max_abs = float((a - b).abs().max())
    rel = float((a - b).norm() / b.norm())
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    return max_abs, rel, cos


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, F, attn):
    """Phase 3: each kernel vs its twin at its path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    d = C // H
    scale = d ** -0.5

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    x = randn(B, L, C)
    # [C, 3C] view of a torch-layout [3C, C] weight, as the model passes
    # qkv.weight.t(): the kernel reads it without a copy
    w = randn(3 * C, C, std=0.02).t()
    qkv = randn(B, L, 3 * C, std=0.64)  # the spread of x @ w
    lns = 1.0 + randn(C, std=0.1, dtype=torch.float32)
    lnb = randn(C, std=0.1, dtype=torch.float32)

    def sdpa_packed(qkv_):
        q, k, v = qkv_.view(B, L, 3, H, d).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v)

    proj_flops = 2.0 * B * L * C * 3 * C
    attn_flops = 4.0 * B * H * L * L * d
    io = lambda *ts: float(sum(t.numel() * t.element_size() for t in ts))
    cases = [
        dict(name="packed_attention",
             replaces="uspace_tpu/ops/attention.py:258 (_packed_fwd_kernel)",
             kernel=lambda: attn.fused_qkv_attention(qkv, H),
             plain=lambda: attn.packed_attention_plain(qkv, H, scale),
             library=lambda: sdpa_packed(qkv),
             bytes=io(qkv) + io(x), flops=attn_flops),
        dict(name="qkvproj_attention",
             replaces="uspace_tpu/ops/attention.py:468 (_qkv_attn_kernel)",
             kernel=lambda: attn.fused_qkvproj_attention(x, w, H),
             plain=lambda: attn.qkvproj_attention_plain(x, w, H, scale),
             library=lambda: sdpa_packed(torch.matmul(x, w)),
             bytes=io(x, w) + io(x), flops=proj_flops + attn_flops),
        dict(name="ln_qkvproj_attention",
             replaces="uspace_tpu/ops/attention.py:654 (_qkv_attn_kernel_ln)",
             kernel=lambda: attn.fused_ln_qkvproj_attention(x, lns, lnb, w, H),
             plain=lambda: attn.ln_qkvproj_attention_plain(
                 x, lns, lnb, w, H, scale, 1e-5),
             library=lambda: sdpa_packed(torch.matmul(
                 F.layer_norm(x, (C,), lns.to(bf), lnb.to(bf), 1e-5), w)),
             bytes=io(x, w, lns, lnb) + io(x), flops=proj_flops + attn_flops),
    ]
    # the backward at the training path's batch
    qkv_t = randn(TRAIN_B, L, 3 * C, std=0.64)
    do_t = randn(TRAIN_B, L, C)
    qkv_l = qkv_t.detach().requires_grad_()
    o_l = F.scaled_dot_product_attention(
        *qkv_l.view(TRAIN_B, L, 3, H, d).permute(2, 0, 3, 1, 4))
    go_l = do_t.view(TRAIN_B, L, H, d).transpose(1, 2)
    cases.append(dict(
        name="packed_attention_bwd",
        source="uspace_tpu_torch/ops/csrc/attention_bwd.cu",
        replaces="uspace_tpu/ops/attention.py:285 (_packed_bwd_kernel)",
        kernel=lambda: attn.packed_attention_bwd(qkv_t, do_t, H),
        plain=lambda: attn.packed_attention_bwd_plain(qkv_t, do_t, H, scale),
        # SDPA's backward on a retained graph: a yardstick only
        library=lambda: torch.autograd.grad(o_l, qkv_l, go_l,
                                            retain_graph=True),
        bytes=io(qkv_t, do_t) + io(qkv_t),
        flops=10.0 * TRAIN_B * H * L * L * d,
        tol=(BWD_MAX_ABS, BWD_REL_L2), shape=f"B={TRAIN_B} L={L} C={C} "
        f"H={H} bf16"))
    results = []
    for case in cases:
        before = attn.LAUNCHES[case["name"]]
        out = case["kernel"]()
        torch.cuda.synchronize()
        if attn.LAUNCHES[case["name"]] != before + 1:
            fail(f"{case['name']}: the wrapper did not launch its kernel")
        ref = case["plain"]()
        max_abs, rel, cos = compare(torch, out, ref)
        tol_abs, tol_rel = case.get("tol", (KERNEL_MAX_ABS, KERNEL_REL_L2))
        ok = max_abs <= tol_abs and rel <= tol_rel
        del out, ref
        ms = time_ms(torch, case["kernel"])
        plain_ms = time_ms(torch, case["plain"], iters=5)
        library_ms = time_ms(torch, case["library"])
        bound_ms, bound_by = bound(case["bytes"], case["flops"])
        r = dict(name=case["name"], route="cuda",
                 source=case.get("source",
                                 "uspace_tpu_torch/ops/csrc/attention.cu"),
                 replaces=case["replaces"], launches=0, max_abs_err=max_abs,
                 rel_l2=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms,
                 shape=case.get("shape", f"B={B} L={L} C={C} H={H} bf16"))
        log(f"kernel {case['name']}: max_abs {max_abs:.3e} (tol "
            f"{tol_abs}) rel_l2 {rel:.3e} (tol {tol_rel}) | "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} "
            f"ms, bound {bound_ms * 1e3:.1f} us ({bound_by})")
        if not ok:
            fail(f"{case['name']} disagrees with its plain twin")
        results.append(r)
    return results


def decode_run(torch, flow, model, z, steps):
    sk = {"solver": "fixed", "solver_fix": "euler",
          "solver_fix_step": 1.0 / steps}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = flow.decode(lambda t, x: model(x, t)[0], z, sk)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_path(torch, attn, cfg, dev, by_key):
    """Phase 7: TRAIN_STEPS timed steps of U-ViT-large at TRAIN_B after
    TRAIN_WARMUP steps, with the JAX bench's optimizer (bench.py:567-581)."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.data.datasets import SyntheticFeatures
    from uspace_tpu_torch.train.state import (
        TrainState,
        get_lr_schedule,
        get_optimizer,
    )
    from uspace_tpu_torch.train.step import make_train_step

    model = build_train_model(cfg, dev, seed=0, attn_impl="pallas_packed",
                              remat_exempt=REMAT_EXEMPT)
    n_remat = sum(model.remat)
    lr = get_lr_schedule("customized", 2e-4, warmup_steps=100)
    tx = get_optimizer("adam", lr, betas=(0.99, 0.99), weight_decay=0.03)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, lr_schedule=lr, ema_rate=0.995,
                           latents_from_moments=True)
    n = TRAIN_WARMUP + TRAIN_STEPS
    data = SyntheticFeatures(num=n * TRAIN_B, shape=(32, 32, 8), seed=0)
    batches = [torch.from_numpy(data.batch(range(i * TRAIN_B,
                                                 (i + 1) * TRAIN_B))["x"]
                                ).to(dev) for i in range(n)]
    gen = torch.Generator(device=dev).manual_seed(1)
    metrics = [step(state, {"x": batches[i]}, gen)
               for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_launches()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, n):
        metrics.append(step(state, {"x": batches[i]}, gen))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(attn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    skips = sum(float(m["nonfinite_skip"]) for m in metrics)
    blocks = cfg["nnet"]["depth"] + 1
    want = {"packed_attention": TRAIN_STEPS * (blocks + n_remat),
            "packed_attention_bwd": TRAIN_STEPS * blocks,
            "qkvproj_attention": 0, "ln_qkvproj_attention": 0}
    ips = TRAIN_B * TRAIN_STEPS / secs
    log(f"train (pallas_packed, batch {TRAIN_B}, remat_exempt {REMAT_EXEMPT}"
        f": {n_remat} of {blocks} blocks rematted): {TRAIN_STEPS} steps in "
        f"{secs:.3f} s, {ips:.3f} img/s, peak {peak_gb:.2f} GiB, launches "
        f"{launches} (expected {want}), losses {losses[0]:.5f} .. "
        f"{losses[-1]:.5f}, non-finite skips {skips:.0f}, step "
        f"{int(state.step)}")
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    if not all(map(math.isfinite, losses)) or skips:
        fail(f"training losses {losses}, non-finite skips {skips}")
    for k in ("packed_attention", "packed_attention_bwd"):
        by_key[k]["launches"] = launches[k]
    return dict(batch=TRAIN_B, steps=TRAIN_STEPS, remat_exempt=REMAT_EXEMPT,
                rematted_blocks=n_remat, seconds=secs, imgs_per_s=ips,
                ms_per_step=secs / TRAIN_STEPS * 1e3, peak_gib=peak_gb,
                launches=launches, losses=losses)


def grad_agreement(torch, attn, cfg, dev):
    """Phase 8: one global gradient at GRAD_B from each view, same
    weights and batch (f32 masters, bf16 compute, full remat)."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.core import interpolant

    g = torch.Generator(device=dev).manual_seed(5)
    x1 = torch.randn((GRAD_B, 32, 32, 4), generator=g, device=dev) * 0.18
    t, xt, ut = interpolant.sample_path(x1, 1e-4, g)
    grads, launches = {}, {}
    ref_state = None
    for impl in ("xla", "pallas_packed", "auto"):
        model = build_train_model(cfg, dev, seed=2, attn_impl=impl,
                                  remat_exempt=0)
        if ref_state is None:
            ref_state = model.state_dict()
        model.load_state_dict(ref_state)
        attn.reset_launches()
        loss = interpolant.cfm_loss(model(xt, t)[0], ut).mean()
        gs = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launches[impl] = dict(attn.LAUNCHES)
        grads[impl] = torch.cat([x.flatten() for x in gs])
        del model, gs, loss
    out = {}
    blocks = cfg["nnet"]["depth"] + 1
    want = {"pallas_packed": {"packed_attention": 2 * blocks,
                              "qkvproj_attention": 0,
                              "ln_qkvproj_attention": 0,
                              "packed_attention_bwd": blocks},
            "auto": {"packed_attention": 0, "qkvproj_attention": 2 * blocks,
                     "ln_qkvproj_attention": 0,
                     "packed_attention_bwd": blocks}}
    for impl, ref in (("pallas_packed", "xla"), ("auto", "pallas_packed")):
        _, rel, cos = compare(torch, grads[impl], grads[ref])
        log(f"gradient {impl} vs {ref} at batch {GRAD_B}: cos {cos:.7f} "
            f"(min {GRAD_MIN_COS}) rel_l2 {rel:.3e} (max {GRAD_MAX_REL_L2}); "
            f"launches {launches[impl]}")
        if launches[impl] != want[impl]:
            fail(f"{impl} gradient launches {launches[impl]}, expected "
                 f"{want[impl]}")
        if not (cos >= GRAD_MIN_COS and rel <= GRAD_MAX_REL_L2):
            fail(f"{impl} gradient disagrees with {ref}")
        out[f"{impl}_vs_{ref}"] = dict(cos=cos, rel_l2=rel,
                                       launches=launches[impl])
    return out


def train_entry_point(torch, cfg, dev):
    """Phase 9: cli.train_lfm.run for 2 steps into a temporary workdir;
    its checkpoint's params load strictly into a fresh model."""
    from uspace_tpu_torch.cli import train_lfm
    from uspace_tpu_torch.train import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = train_lfm.run(config="uvit_large", n_steps=2, batch=GRAD_B,
                            seed=3, workdir=tmp, remat_exempt=REMAT_EXEMPT,
                            log=log)
        secs = time.perf_counter() - t0
        losses = [h["loss"] for h in out["history"]]
        del out["state"], out["model"]
        sd = checkpoint.load(out["checkpoint"], map_location=dev)
        fresh = train_lfm.build_train_model(cfg, dev, seed=4)
        fresh.load_state_dict(sd["params"], strict=True)
        step = int(sd["step"])
        size_gb = os.path.getsize(out["checkpoint"]) / 2**30
    log(f"train_lfm.run: 2 steps at batch {GRAD_B} in {secs:.1f} s (build "
        f"and checkpoint included), losses {losses}, checkpoint step {step} "
        f"({size_gb:.2f} GiB) reloaded with strict=True")
    if step != 2 or not all(map(math.isfinite, losses)):
        fail(f"train_lfm: step {step}, losses {losses}")
    return dict(seconds=secs, losses=losses, checkpoint_gib=size_gb)


def main():
    ap = argparse.ArgumentParser(description="Smoke test of the port on one "
                                 "NVIDIA card")
    ap.add_argument("--out", default="",
                    help="also write the whole report here as JSON")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not os.path.isdir(os.path.join(HERE, "uspace_tpu_torch")):
        fail("uspace_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.nn.functional as F

    from uspace_tpu_torch.cli import sample_lfm
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.core import flow
    from uspace_tpu_torch.ops import _build
    from uspace_tpu_torch.ops import attention as attn

    report = {}
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind} x {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    report.update(card=card, kind=kind, torch=torch.__version__)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    _build.load("attention")
    report["build_s"] = time.perf_counter() - t0
    log(f"built kernels in {report['build_s']:.1f} s")

    # 3. kernels vs twins
    kernels = check_kernels(torch, F, attn)
    by_key = {k["name"]: k for k in kernels}

    # 4. the main path: U-ViT-large Euler-50 at batch 50
    cfg = get_config("uvit_large")
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    plain = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="xla")
    plain.load_state_dict(model.state_dict())
    z = torch.randn((B, 32, 32, 4), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    with torch.no_grad():  # warm-up: cuBLAS/cuDNN handles, allocator
        for m in (model, plain):
            m(z.to(torch.bfloat16), torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_launches()
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = dict(attn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = (cfg["nnet"]["depth"] + 1) * STEPS
    log(f"main path (auto): {secs:.3f} s, {B / secs:.3f} img/s, launches "
        f"{launches}, peak {peak_gb:.2f} GiB")
    if launches["qkvproj_attention"] != expected:
        fail(f"qkvproj kernel launched {launches['qkvproj_attention']} times, "
             f"expected {expected}")
    by_key["qkvproj_attention"]["launches"] = launches["qkvproj_attention"]
    lat_plain, secs_plain = decode_run(torch, flow, plain, z, STEPS)
    max_abs, rel, cos = compare(torch, lat, lat_plain)
    log(f"plain path (xla): {secs_plain:.3f} s, {B / secs_plain:.3f} img/s; "
        f"latents cos {cos:.7f} (min {PATH_MIN_COS}) rel_l2 {rel:.3e} "
        f"(max {PATH_MAX_REL_L2})")
    if tuple(lat.shape) != (B, 32, 32, 4) or lat.dtype != torch.float32:
        fail(f"latents {tuple(lat.shape)} {lat.dtype}")
    if not (cos >= PATH_MIN_COS and rel <= PATH_MAX_REL_L2):
        fail("main path disagrees with the plain path")
    report["main_path"] = dict(
        steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs,
        plain_seconds=secs_plain, plain_imgs_per_s=B / secs_plain,
        cos=cos, rel_l2=rel, max_abs=max_abs, launches=launches,
        peak_gib=peak_gb)

    # 5. the other two kernel views, a few Euler steps each
    ref_short, _ = decode_run(torch, flow, plain, z, SHORT_STEPS)
    for impl, key in (("pallas_packed", "packed_attention"),
                      ("pallas_lnmlp", "ln_qkvproj_attention")):
        view = sample_lfm.build_model(cfg, dev, seed=0, attn_impl=impl)
        view.load_state_dict(model.state_dict())
        attn.reset_launches()
        out, secs_v = decode_run(torch, flow, view, z, SHORT_STEPS)
        n = attn.LAUNCHES[key]
        _, rel_v, cos_v = compare(torch, out, ref_short)
        want = (cfg["nnet"]["depth"] + 1) * SHORT_STEPS
        log(f"{impl}: {SHORT_STEPS} Euler steps in {secs_v:.3f} s, {key} "
            f"launches {n} (expected {want}), cos {cos_v:.7f} rel_l2 "
            f"{rel_v:.3e}")
        if n != want or sum(attn.LAUNCHES.values()) != n:
            fail(f"{impl}: launches {dict(attn.LAUNCHES)}, expected {want} "
                 f"of {key}")
        if not (cos_v >= PATH_MIN_COS and rel_v <= PATH_MAX_REL_L2):
            fail(f"{impl} disagrees with the plain path")
        by_key[key]["launches"] = n
        report[impl] = dict(steps=SHORT_STEPS, seconds=secs_v, cos=cos_v,
                            rel_l2=rel_v, launches=n)
        del view
    del model, plain

    # 6. the sampling entry point
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = sample_lfm.run(config="uvit_large", n_samples=2 * B, batch=B,
                               steps=STEPS, seed=3, out=tmp)
        secs_cli = time.perf_counter() - t0
        arrays = [np.load(p) for p in paths]
        shapes = [a.shape for a in arrays]
        log(f"sample_lfm.run: {len(paths)} batches {shapes} in "
            f"{secs_cli:.1f} s")
        if shapes != [(B, 32, 32, 4)] * 2 or not all(
                np.isfinite(a).all() for a in arrays):
            fail(f"sample_lfm wrote {shapes}")
    report["sample_lfm_seconds"] = secs_cli

    # 7. the training path
    report["train"] = train_path(torch, attn, cfg, dev, by_key)

    # 8. gradient agreement: kernel vs plain, auto vs pallas_packed
    report["grad_agreement"] = grad_agreement(torch, attn, cfg, dev)

    # 9. the training entry point
    report["train_lfm"] = train_entry_point(torch, cfg, dev)

    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was never launched on its path")
    report["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
