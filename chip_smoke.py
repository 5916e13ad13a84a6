#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uspace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. the card: `nvidia-smi` name and power limit, TF32 off for comparisons;
2. build every CUDA kernel from the sources in this checkout (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin at the main path's shapes
   (B=50, L=257, C=1024, H=16, bf16): max-abs and rel-L2 within the
   tolerances below; kernel, twin and library-call times with CUDA events;
   the bound of the same work on an H100 SXM;
4. the main path: U-ViT-large (embed 1024, depth 20, 16 heads, patch 2) in
   bf16 with seeded random weights, Euler-50 at batch 50 through
   `core.flow.decode` with attn_impl="auto": 21 x 50 = 1050 launches of the
   QKV-projection kernel, latents against the plain path (attn_impl="xla")
   from the same z, img/s of both, peak memory;
5. the "pallas_packed" and "pallas_lnmlp" views for a few Euler steps, their
   launch counts and agreement with the plain path;
6. the entry point `cli.sample_lfm.run` writing two latent batches.

Prints the `kernels` JSON line and then, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With `--out PATH` the whole report is also written to PATH as JSON.
"""

import argparse
import json
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
# a whole solve, fused kernels vs plain attention: the kernels normalise
# after P.V (the plain softmax before), so bf16 roundings differ in every
# attention call; measured on an H100: cos >= 0.9999982, rel-L2 <= 1.9e-3
PATH_MIN_COS = 0.9999
PATH_MAX_REL_L2 = 1e-2

# H100 SXM published peaks (dense bf16, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

B, L, C, H = 50, 257, 1024, 16
STEPS = 50
SHORT_STEPS = 4


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
    a, b = out.float(), ref.float()
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
    """Phase 3: each kernel vs its twin at the main path's shapes."""
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
    results = []
    for case in cases:
        before = attn.LAUNCHES[case["name"]]
        out = case["kernel"]()
        torch.cuda.synchronize()
        if attn.LAUNCHES[case["name"]] != before + 1:
            fail(f"{case['name']}: the wrapper did not launch its kernel")
        ref = case["plain"]()
        max_abs, rel, cos = compare(torch, out, ref)
        ok = max_abs <= KERNEL_MAX_ABS and rel <= KERNEL_REL_L2
        ms = time_ms(torch, case["kernel"])
        plain_ms = time_ms(torch, case["plain"], iters=5)
        library_ms = time_ms(torch, case["library"])
        bound_ms, bound_by = bound(case["bytes"], case["flops"])
        r = dict(name=case["name"], route="cuda",
                 source="uspace_tpu_torch/ops/csrc/attention.cu",
                 replaces=case["replaces"], launches=0, max_abs_err=max_abs,
                 rel_l2=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms,
                 shape=f"B={B} L={L} C={C} H={H} bf16")
        log(f"kernel {case['name']}: max_abs {max_abs:.3e} (tol "
            f"{KERNEL_MAX_ABS}) rel_l2 {rel:.3e} (tol {KERNEL_REL_L2}) | "
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
