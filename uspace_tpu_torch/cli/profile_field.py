"""Where one evaluation of the sampling field spends its device time.

Builds a config's field (seeded random weights, compute dtype), warms it
up, then traces ``--evals`` evaluations at ``--batch`` with
``torch.profiler`` and prints the device time per kernel name, grouped
into the layers that launch them, beside the host wall time (the
difference is the device's idle share). Needs a CUDA card.

    python -m uspace_tpu_torch.cli.profile_field --config uvit_large \\
        --batch 50 --attn_impl auto --out profile_field.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import torch

from .. import resolve_device
from ..configs import get_config
from .sample_lfm import build_model

# kernel-name fragments -> the layer that launches them
GROUPS = (
    ("attention kernel (ours)", ("attention_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet")),
    ("conv (cuDNN)", ("conv", "Conv", "cudnn")),
    ("softmax", ("softmax", "Softmax")),
    ("reduction", ("reduce", "Reduce")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "Copy",
                            "cat", "Cat", "fill", "Fill")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


@torch.no_grad()
def profile(config: str = "uvit_large", batch: int = 50, evals: int = 3,
            attn_impl: str = "auto", seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_field measures the card; it needs CUDA")
    cfg = get_config(config)
    model = build_model(cfg, dev, seed, attn_impl=attn_impl)
    c, h, w = cfg["z_shape"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((batch, h, w, c), generator=g, device=dev)
    t = torch.full((batch,), 0.5, device=dev)
    for _ in range(2):
        model(x, t)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            model(x, t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / evals
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += e.time_range.elapsed_us() / 1e3 / evals
            kernels[e.name][1] += 1
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        groups[_group(name)] += ms
    busy = sum(groups.values())
    return dict(
        config=config, batch=batch, attn_impl=attn_impl, evals=evals,
        card=torch.cuda.get_device_name(0), wall_ms_per_eval=wall * 1e3,
        device_ms_per_eval=busy,
        idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
        groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=n[:120], ms=ms, calls=cnt // evals)
                     for n, (ms, cnt) in sorted(kernels.items(),
                                                key=lambda kv: -kv[1][0])[:15]],
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="uvit_large")
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--evals", type=int, default=3)
    ap.add_argument("--attn_impl", default="auto")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    rep = profile(a.config, a.batch, a.evals, a.attn_impl)
    print(f"{rep['card']}: {rep['config']} batch {rep['batch']} "
          f"attn_impl={rep['attn_impl']}: wall {rep['wall_ms_per_eval']:.2f} "
          f"ms/eval, device {rep['device_ms_per_eval']:.2f} ms/eval, idle "
          f"{rep['idle_share']:.3f}")
    for g, ms in rep["groups_ms"].items():
        print(f"  {g:28s} {ms:9.3f} ms")
    for k in rep["top_kernels"]:
        print(f"  {k['ms']:9.3f} ms x{k['calls']:4d}  {k['name']}")
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main()
