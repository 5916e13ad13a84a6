"""Time the attention kernels of this checkout against another source of them.

Builds ``--base`` (an ``attention.cu`` with the same C interface, e.g. from
``git archive`` of the parent commit) beside this checkout's
``ops/csrc/attention.cu`` and times each of the three kernels at the main
path's shapes (B=50, L=257, C=1024, H=16, bf16) with CUDA events, the two
builds alternating base, new, new, base, ... on one card. Needs a CUDA card.

    python -m uspace_tpu_torch.cli.kernel_ab --base old/attention.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import _build

B, L, C, H = 50, 257, 1024, 16


def _load(path: str, out: str) -> ctypes.CDLL:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True)
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES["attention"].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, help="attention.cu to compare")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--pairs", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"base": _load(a.base, str(_build.BUILD_DIR / "ab_base.so")),
            "new": _build.load("attention")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(B, L, C, generator=g, device=dev).to(bf)
    w = (torch.randn(3 * C, C, generator=g, device=dev) * 0.02).to(bf)
    qkv = (torch.randn(B, L, 3 * C, generator=g, device=dev) * 0.64).to(bf)
    lns = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
    lnb = 0.1 * torch.randn(C, generator=g, device=dev)
    out = torch.empty(B, L, C, dtype=bf, device=dev)
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls = {
        "packed_attention": lambda lib: lib.uspace_packed_attention(
            qkv.data_ptr(), out.data_ptr(), B, L, H, 0.125, s),
        "qkvproj_attention": lambda lib: lib.uspace_qkvproj_attention(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, L, H, 0.125, s),
        "ln_qkvproj_attention": lambda lib: lib.uspace_ln_qkvproj_attention(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, L, H, 0.125, 1e-5, s),
    }

    def time_ms(call, lib):
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(a.iters):
            if call(lib):
                raise RuntimeError("kernel launch failed")
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / a.iters

    order = ["base", "new", "new", "base"] * ((a.pairs + 1) // 2)
    for name, call in calls.items():
        runs = [(side, time_ms(call, libs[side])) for side in order]
        print(json.dumps({
            "kernel": name, "card": torch.cuda.get_device_name(0),
            "base_ms": [t for side, t in runs if side == "base"],
            "new_ms": [t for side, t in runs if side == "new"]}), flush=True)


if __name__ == "__main__":
    main()
