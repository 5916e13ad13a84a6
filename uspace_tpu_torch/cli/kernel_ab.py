"""Time the kernels of one CUDA source of this checkout against another
version of that source.

Builds ``--base`` (a ``<source>.cu`` with the same C interface, e.g. from
``git archive`` of the parent commit) beside this checkout's
``ops/csrc/<source>.cu`` and times each of its kernels at its path's shapes
(``attention``: the bf16 and int8 sampling kernels at B=50;
``attention_bwd``: the backward at B=128; L=257, C=1024, H=16, bf16;
``mlp_int8``, ``mlp_w8`` and ``mlp_bf16``: the W8A8, weight-only int8 and
bf16 MLP kernels on the 12850 rows of B=50, hidden 4096;
``attention_block``: the attention sub-block's own passes at B=50 (the
bf16-chain LN, the attention output's row codes, the bf16 and the int8
projection with bias and residual); ``attention_fwd``: the [B, H, L, D]
kernel at the SD-UNet-large shape, B=50, H=8, L=1024, D=32;
``fused_attention_bwd``: its backward at the SD-UNet-large training shape,
B=128, H=8, L=1024, D=32; ``delta_attention``: the stage-delta attention
halves' own passes at B=50 (the LN codes of the padded base rows and of a
stage delta, the difference codes, the f32 and the two delta GEMMs, the qkv
re-coding); ``delta_mlp``: the stage-delta base and delta MLP kernels of
the three hidden modes on 12850 rows, hidden 4096)
with CUDA events, the two builds alternating base, new, new, base, ... on
one card. An entry point that the base source lacks is timed on the new
build alone (``attention``: the LN pass, ``ln_rows``, and the wgmma
projection, ``qkv_gemm``, the pieces of rows 2 and 3); a base
``attention.cu`` from before the projection's workspace arguments is
called with its own interface. ``--tree <checkout>`` instead
runs ``chip_smoke.py``'s phase 3 (every kernel against its twin, timed at
its path's shape, with its library yardstick) from another checkout, such
as an unpacked ``git archive`` of the parent commit, and from this one, in
alternating processes, which times the routes that call one source's
kernels from another (rows 10, 18 and 19 run row 1 or 2's kernels). Needs
a CUDA card.

    python -m uspace_tpu_torch.cli.kernel_ab --base old/attention.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source attention_bwd \
        --base old/attention_bwd.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source mlp_int8 \
        --base old/mlp_int8.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source mlp_w8 \
        --base old/mlp_w8.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source mlp_bf16 \
        --base old/mlp_bf16.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source attention_block \
        --base old/attention_block.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source attention_fwd \
        --base old/attention_fwd.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source fused_attention_bwd \
        --base old/fused_attention_bwd.cu
    python -m uspace_tpu_torch.cli.kernel_ab --source delta_mlp \
        --base old/delta_mlp.cu
    python -m uspace_tpu_torch.cli.kernel_ab --tree old
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops.quant import quantized_weight

B, L, C, H = 50, 257, 1024, 16
TRAIN_B = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# attention.cu before its bf16 projection routes took workspaces
_LEGACY_ATTENTION = {
    "uspace_qkvproj_attention": (_P, _P, _P, _I, _I, _I, _F, _P),
    "uspace_ln_qkvproj_attention": (_P,) * 5 + (_I, _I, _I, _F, _F, _P),
}


def _legacy(lib: ctypes.CDLL) -> bool:
    """An attention.cu whose projection routes take no workspace."""
    return (hasattr(lib, "uspace_qkvproj_attention")
            and not hasattr(lib, "uspace_qkv_gemm"))


def _load(source: str, path: str, out: str) -> ctypes.CDLL:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True)
    lib = ctypes.CDLL(out)
    sigs = dict(_build.SIGNATURES[source])
    if source == "attention" and _legacy(lib):
        sigs.update(_LEGACY_ATTENTION)
    for fn, argtypes in sigs.items():
        if not hasattr(lib, fn):
            continue
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


# chip_smoke.py's phase 3 in the checkout given as argv[1], one JSON line
_PHASE3 = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.nn.functional as F
import chip_smoke
from uspace_tpu_torch.ops import _build, attention, mlp, quant
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
rows, _, _ = chip_smoke.check_kernels(torch, F, attention, mlp, quant)
print("PHASE3", json.dumps([{k: r[k] for k in ("name", "ms", "library_ms")}
                            for r in rows]))
"""


def phase3_ab(other: str, pairs: int) -> None:
    """Phase 3 of ``other`` and of this checkout in alternating processes
    (other, this, this, other, ...), each kernel's times printed as JSON."""
    trees = {"base": str(Path(other).resolve()),
             "new": str(Path(__file__).resolve().parents[2])}
    times = {}
    for side in ["base", "new", "new", "base"] * ((pairs + 1) // 2):
        out = subprocess.run([sys.executable, "-c", _PHASE3, trees[side]],
                             check=True, capture_output=True, text=True)
        line = [l for l in out.stdout.splitlines() if l.startswith("PHASE3")]
        for r in json.loads(line[-1][len("PHASE3"):]):
            t = times.setdefault(r["name"], {"base_ms": [], "new_ms": [],
                                             "library_ms": []})
            t[f"{side}_ms"].append(r["ms"])
            t["library_ms"].append(r["library_ms"])
    for name, t in times.items():
        print(json.dumps({"kernel": name, "card": torch.cuda.get_device_name(0),
                          **t}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="attention",
                    choices=sorted(_build.SIGNATURES))
    ap.add_argument("--base", help="the other version of <source>.cu")
    ap.add_argument("--tree", help="another checkout: A/B of chip_smoke.py's "
                    "phase 3 instead")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--pairs", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    if a.tree:
        phase3_ab(a.tree, a.pairs)
        return
    if not a.base:
        ap.error("--base or --tree is required")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"base": _load(a.source, a.base,
                          str(_build.BUILD_DIR / f"ab_{a.source}.so")),
            "new": _build.load(a.source)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(B, L, C, generator=g, device=dev).to(bf)
    w = (torch.randn(3 * C, C, generator=g, device=dev) * 0.02).to(bf)
    qkv = (torch.randn(B, L, 3 * C, generator=g, device=dev) * 0.64).to(bf)
    lns = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
    lnb = 0.1 * torch.randn(C, generator=g, device=dev)
    out = torch.empty(B, L, C, dtype=bf, device=dev)
    qkv_ws = torch.empty(B, L, 3 * C, dtype=bf, device=dev)
    xln_ws = torch.empty(B, L, C, dtype=bf, device=dev)
    qkv_t = (torch.randn(TRAIN_B, L, 3 * C, generator=g, device=dev)
             * 0.64).to(bf)
    do_t = torch.randn(TRAIN_B, L, C, generator=g, device=dev).to(bf)
    dqkv = torch.empty_like(qkv_t)
    stats = torch.empty(TRAIN_B * H * 3 * L, device=dev)
    q = quantized_weight(
        (torch.randn(3 * C, C, generator=g, device=dev) * 0.02).t())
    rows, hid = B * L, 4 * C
    q1 = quantized_weight(
        (torch.randn(hid, C, generator=g, device=dev) * 0.02).t())
    q2 = quantized_weight(
        (torch.randn(C, hid, generator=g, device=dev) * 0.02).t())
    b1 = 0.02 * torch.randn(hid, generator=g, device=dev)
    b2 = 0.02 * torch.randn(C, generator=g, device=dev)
    cs4 = q2.colsums(4)
    mw = (q1.q.data_ptr(), q1.scale.data_ptr(), b1.data_ptr(),
          q2.q.data_ptr(), q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
          out.data_ptr(), rows, C, hid, C, 4)
    w8 = (q1.q.data_ptr(), q1.scale.data_ptr(), b1.data_ptr(),
          q2.q.data_ptr(), q2.scale.data_ptr(), b2.data_ptr(), out.data_ptr(),
          rows, C, hid, C)
    w1b, w2b = q1.q.to(bf), q2.q.to(bf)  # bf16 weights, torch layout
    bw = (w1b.data_ptr(), b1.data_ptr(), w2b.data_ptr(), b2.data_ptr(),
          out.data_ptr(), rows, C, hid, C)
    wp = (torch.randn(C, C, generator=g, device=dev) * 0.02).to(bf)
    qp = quantized_weight(wp.float().t())
    codes = torch.empty(rows, C, dtype=torch.int8, device=dev)
    sr = torch.empty(rows, device=dev)
    # the SD-UNet-large self-attention at 32 x 32 latents
    q7, k7, v7, o7 = (torch.randn(50, 8, 1024, 32, generator=g,
                                  device=dev).to(bf) for _ in range(4))
    # and its backward at the SD-UNet-large training batch
    q8, k8, v8, do8, dq8, dk8, dv8 = (
        torch.randn(TRAIN_B, 8, 1024, 32, generator=g, device=dev).to(bf)
        for _ in range(7))
    st8 = torch.empty(TRAIN_B * 8 * 3 * 1024, device=dev)
    # the stage-delta field's buffers (padded base rows Lp = 288)
    lp = (L + 31) // 32 * 32
    ucodes = torch.empty(B * lp, C, dtype=torch.int8, device=dev)
    us = torch.empty(B * lp, device=dev)
    qkv32 = torch.empty(B * lp, 3 * C, device=dev)
    cq = torch.zeros(B * lp, 3 * C, dtype=torch.int8, device=dev)
    cs = torch.full((B * lp,), 0.01, device=dev)
    qkvd = torch.empty(B, L, 3 * C, dtype=bf, device=dev)
    x1 = (x.float() + 0.01 * torch.randn(x.shape, generator=g, device=dev)
          ).to(bf)
    gp_q = torch.randint(-127, 128, (rows, hid), generator=g, device=dev,
                         dtype=torch.int8)
    gp_s = torch.full((rows, 4), 0.01, device=dev)
    # the "exact" / "gelu" caches: the pre-GELU hidden's codes and scales,
    # and the affine codes, scales and zero points of its GELU
    e_q, g_q = gp_q.clone(), gp_q.clone()
    e_s = torch.full((rows, 4), 0.02, device=dev)
    g_s = torch.full((rows, 4), 0.005, device=dev)
    g_z = torch.full((rows, 4), 0.6, device=dev)
    m_out = torch.empty(rows, C, dtype=bf, device=dev)
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls = {
        "packed_attention": lambda lib: lib.uspace_packed_attention(
            qkv.data_ptr(), out.data_ptr(), B, L, H, 0.125, s),
        "qkvproj_attention": lambda lib: lib.uspace_qkvproj_attention(
            x.data_ptr(), w.data_ptr(),
            *(() if _legacy(lib) else (qkv_ws.data_ptr(),)),
            out.data_ptr(), B, L, H, 0.125, s),
        "ln_qkvproj_attention": lambda lib: lib.uspace_ln_qkvproj_attention(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
            *(() if _legacy(lib) else (xln_ws.data_ptr(), qkv_ws.data_ptr())),
            out.data_ptr(), B, L, H, 0.125, 1e-5, s),
        "ln_rows": lambda lib: lib.uspace_ln_rows(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), xln_ws.data_ptr(),
            B * L, C, 1e-5, s),
        # w as the [3C, C] rows of a torch Linear weight
        "qkv_gemm": lambda lib: lib.uspace_qkv_gemm(
            xln_ws.data_ptr(), w.data_ptr(), qkv_ws.data_ptr(), B * L, 3 * C,
            C, s),
        "packed_attention_bwd": lambda lib: lib.uspace_packed_attention_bwd(
            qkv_t.data_ptr(), do_t.data_ptr(), dqkv.data_ptr(),
            stats.data_ptr(), TRAIN_B, L, H, 0.125, s),
        "qkvproj_attention_int8": lambda lib: lib.uspace_qkvproj_attention_int8(
            x.data_ptr(), q.q.data_ptr(), q.scale.data_ptr(), out.data_ptr(),
            B, L, H, 0.125, s),
        "ln_qkvproj_attention_int8":
            lambda lib: lib.uspace_ln_qkvproj_attention_int8(
                x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q.q.data_ptr(),
                q.scale.data_ptr(), out.data_ptr(), B, L, H, 0.125, 1e-5, s),
        "mlp_int8": lambda lib: lib.uspace_mlp_int8(x.data_ptr(), *mw, s),
        "ln_mlp_int8": lambda lib: lib.uspace_ln_mlp_int8(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), *mw, 1e-5, s),
        "mlp_w8": lambda lib: lib.uspace_mlp_w8(x.data_ptr(), *w8, s),
        "ln_mlp_w8": lambda lib: lib.uspace_ln_mlp_w8(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), *w8, 1e-5, s),
        "mlp_bf16": lambda lib: lib.uspace_mlp_bf16(x.data_ptr(), *bw, s),
        "ln_mlp_bf16": lambda lib: lib.uspace_ln_mlp_bf16(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), *bw, 1e-5, s),
        "ln_bf16": lambda lib: lib.uspace_ln_bf16(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), out.data_ptr(),
            rows, C, 1e-5, s),
        "row_codes": lambda lib: lib.uspace_row_codes(
            x.data_ptr(), codes.data_ptr(), sr.data_ptr(), rows, C, s),
        "proj_residual": lambda lib: lib.uspace_proj_residual(
            x.data_ptr(), wp.data_ptr(), b2.data_ptr(), x.data_ptr(),
            out.data_ptr(), rows, C, C, s),
        "proj_residual_int8": lambda lib: lib.uspace_proj_residual_int8(
            codes.data_ptr(), sr.data_ptr(), qp.q.data_ptr(),
            qp.scale.data_ptr(), b2.data_ptr(), x.data_ptr(), out.data_ptr(),
            rows, C, C, s),
        "attention_fwd": lambda lib: lib.uspace_attention_fwd(
            q7.data_ptr(), k7.data_ptr(), v7.data_ptr(), o7.data_ptr(), 50, 8,
            1024, 32, 32 ** -0.5, s),
        "fused_attention_bwd": lambda lib: lib.uspace_fused_attention_bwd(
            q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), do8.data_ptr(),
            dq8.data_ptr(), dk8.data_ptr(), dv8.data_ptr(), st8.data_ptr(),
            TRAIN_B, 8, 1024, 32, 32 ** -0.5, s),
    }
    calls.update({
        "ln_codes": lambda lib: lib.uspace_ln_codes(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), ucodes.data_ptr(),
            us.data_ptr(), B, L, lp, C, 1e-5, s),
        "ln_delta_codes": lambda lib: lib.uspace_ln_delta_codes(
            x1.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            codes.data_ptr(), sr.data_ptr(), rows, C, 1e-5, s),
        "diff_codes": lambda lib: lib.uspace_diff_codes(
            x1.data_ptr(), x.data_ptr(), codes.data_ptr(), sr.data_ptr(),
            rows, C, s),
        "int8_gemm_f32": lambda lib: lib.uspace_int8_gemm_f32(
            ucodes.data_ptr(), us.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), qkv32.data_ptr(), B * lp, 3 * C, C, s),
        "qkv_recode": lambda lib: lib.uspace_qkv_recode(
            qkv32.data_ptr(), cq.data_ptr(), cs.data_ptr(), qkvd.data_ptr(),
            B, L, lp, 3 * C, s),
        "qkv_delta": lambda lib: lib.uspace_qkv_delta(
            codes.data_ptr(), sr.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), cq.data_ptr(), cs.data_ptr(), qkvd.data_ptr(),
            B, L, lp, 3 * C, C, s),
        "xm_delta": lambda lib: lib.uspace_xm_delta(
            codes.data_ptr(), sr.data_ptr(), qp.q.data_ptr(),
            qp.scale.data_ptr(), x1.data_ptr(), x.data_ptr(), x.data_ptr(),
            out.data_ptr(), rows, C, C, s),
        "base_mlp_grad": lambda lib: lib.uspace_base_mlp_grad(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            out.data_ptr(), m_out.data_ptr(), gp_q.data_ptr(),
            gp_s.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "delta_mlp_lin": lambda lib: lib.uspace_delta_mlp_lin(
            x1.data_ptr(), x.data_ptr(), gp_q.data_ptr(), gp_s.data_ptr(),
            m_out.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            q1.q.data_ptr(), q1.scale.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), out.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "base_mlp_e": lambda lib: lib.uspace_base_mlp_e(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            out.data_ptr(), m_out.data_ptr(), e_q.data_ptr(),
            e_s.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "base_mlp_eg": lambda lib: lib.uspace_base_mlp_eg(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            out.data_ptr(), m_out.data_ptr(), e_q.data_ptr(),
            e_s.data_ptr(), g_q.data_ptr(), g_s.data_ptr(), g_z.data_ptr(),
            rows, C, hid, 4, 1e-5, s),
        "delta_mlp_exact": lambda lib: lib.uspace_delta_mlp_exact(
            x1.data_ptr(), x.data_ptr(), e_q.data_ptr(), e_s.data_ptr(),
            m_out.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            q1.q.data_ptr(), q1.scale.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), out.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "delta_mlp_g": lambda lib: lib.uspace_delta_mlp_g(
            x1.data_ptr(), x.data_ptr(), e_q.data_ptr(), e_s.data_ptr(),
            g_q.data_ptr(), g_s.data_ptr(), g_z.data_ptr(), m_out.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
            out.data_ptr(), rows, C, hid, 4, 1e-5, s),
    })
    calls = {k: f for k, f in calls.items()
             if f"uspace_{k}" in _build.SIGNATURES[a.source]}

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
        sides = (order if hasattr(libs["base"], f"uspace_{name}")
                 else ["new"] * (len(order) // 2))
        runs = [(side, time_ms(call, libs[side])) for side in sides]
        print(json.dumps({
            "kernel": name, "card": torch.cuda.get_device_name(0),
            "base_ms": [t for side, t in runs if side == "base"],
            "new_ms": [t for side, t in runs if side == "new"]}), flush=True)


if __name__ == "__main__":
    main()
