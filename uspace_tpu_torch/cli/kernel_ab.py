"""Time the kernels of one CUDA source of this checkout against another
version of that source.

Builds ``--base`` (a ``<source>.cu`` with the same C interface, e.g. from
``git archive`` of the parent commit) beside this checkout's
``ops/csrc/<source>.cu`` and times each of its kernels at its path's shapes
(``attention``: the bf16 and int8 sampling kernels at B=50, L=257,
C=1024, H=16, bf16, and row 19's two GEMMs (``qkv_delta``, ``xm_delta``);
``mlp_int8`` (row 14), ``mlp_w8`` and ``mlp_bf16``: the W8A8, weight-only
int8 and bf16 MLP kernels on the 12850 rows of B=50, hidden 4096;
``attention_block``: the attention sub-block's own passes at B=50 (the
row codes of rows 6 and 11, the int8 projection with bias and residual; the
bf16 projection is ``mlp_bf16``'s fc2, timed there as ``row10_proj_ms``);
``attention_fwd``: the [B, H, L, D]
kernel at the SD-UNet-large shape, B=50, H=8, L=1024, D=32;
``fused_attention_bwd``: its backward at the SD-UNet-large training shape,
B=128, H=8, L=1024, D=32, and the packed backward at the U-ViT-large
training shape, B=128, L=257, C=1024, H=16; ``flash_attention``: the blocked online-softmax
kernel at the 512-px SD-UNet-large's top level, B=50, H=8, L=4096, D=32;
``delta_attention``: the stage-delta attention
halves' own passes at B=50 (the LN codes of the padded base rows and of a
stage delta, the difference codes), and row 18's passes of ``attention``'s
GEMM on this checkout's build (``qkv_amax``, ``qkv_code``, and
``base_attn``, which chains them with row 1's core; ``--source attention``
times them against a base that has them and compares the two builds' row
18 outputs bit for bit);
``delta_mlp``: the stage-delta base MLP kernels of the three hidden modes
on 12850 rows, hidden 4096 (rows 20, 21 and 22 each one C entry through a
workspace; row 20's entry took no workspace before, so it is timed on the
new build alone), the pieces of rows 21 and 22, ``base_mlp_codes``,
``base_fc1_grad``, ``base_fc1_eg`` and ``base_fc2``, the wgmma GEMMs of
the delta rows, ``delta_fc1_exact``, ``delta_fc1_lin``, ``delta_fc1_g``
(rows 25, 23, 24) and ``delta_fc2``, and of row 15, ``mlp_int8_codes``,
``mlp_int8_fc1``, ``mlp_int8_fc2`` and ``ln_mlp_int8``, which chains them)
with CUDA events, the two builds alternating base, new, new, base, ... on
one card. The base must have this checkout's C interface (each entry point
of ``ops/_build.SIGNATURES``); an entry point that it lacks is timed on the
new build alone, and rows 12 and 13 run as their pieces in sequence
(``mlp_w8.cu``'s LN pass for row 13, then ``bf16_fc1`` and ``bf16_fc2``,
which are also timed alone). For ``mlp_w8`` row 17's two GEMMs are also
timed apart (``row17_fc1_ms``, ``row17_fc2_ms``). For ``attention`` the int8
and bf16
projections of this checkout are also timed over K = 256 .. 2048 beside
``torch._int_mm``; for ``mlp_bf16`` fc1's GEMM is also timed with fc2's
bias epilogue in place of its GELU one, and row 13's LN pass alone. Beside each device time stands the
host's time a call (``host_us``: the wall time of the timed calls, which
only enqueue, over their number). The two kernels of each backward entry
point are also timed apart (torch.profiler's device time by kernel name,
each build). For ``attention_fwd`` each build is also held to the twin at
chip_smoke.py's three phase-3 shapes (max-abs, rel-L2). For ``attention``,
``attention_fwd``, ``fused_attention_bwd``, ``mlp_w8`` and ``mlp_bf16``
the host time a call of this checkout's Python wrapper of the redesigned
rows (5, 7, 4, 17 and 13) is printed beside its device time.
``--tree <checkout>`` instead
runs ``chip_smoke.py``'s phase 3 (every kernel against its twin, timed at
its path's shape, with its library yardstick) from another checkout, such
as an unpacked ``git archive`` of the parent commit, and from this one, in
alternating processes, which times the routes that call one source's
kernels from another (rows 10, 18 and 19 run row 1 or 2's kernels). Needs
a CUDA card.

    python -m uspace_tpu_torch.cli.kernel_ab --base old/attention.cu
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
    python -m uspace_tpu_torch.cli.kernel_ab --source flash_attention \
        --base old/flash_attention.cu
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
import time
from pathlib import Path

import torch

from ..ops import _build
from ..ops.delta import base_ws_sizes
from ..ops.quant import quantized_weight

B, L, C, H = 50, 257, 1024, 16
TRAIN_B = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry points whose C interface this checkout changed from its parent's
# (row 20's gained its workspace): a base's is not called with it, and they
# are timed on the new build alone
NEW_INTERFACE = {"base_mlp_e"}


def _load(source: str, path: str, out: str) -> ctypes.CDLL:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True)
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES[source].items():
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
rows, shapes, _ = chip_smoke.check_kernels(torch, F, attention, mlp, quant)
print("PHASE3", json.dumps([{k: r[k] for k in ("name", "ms", "library_ms")}
                            for r in rows + shapes]))
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
    stats = torch.empty(TRAIN_B * H * 3 * (-(-L // 64) * 64), device=dev)
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
    xln_rows = torch.empty(rows, C, dtype=bf, device=dev)  # row 16's
    h_rows = torch.empty(rows, hid, dtype=bf, device=dev)  # workspaces
    # bf16 weights at a trained layer's scale, torch layout
    w1h = (torch.randn(hid, C, generator=g, device=dev) * 0.02).to(bf)
    w2h = (torch.randn(C, hid, generator=g, device=dev) * 0.02).to(bf)
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
    # the 512-px SD-UNet-large's top level (64 x 64 latents)
    q9, k9, v9, o9 = (torch.randn(50, 8, 4096, 32, generator=g,
                                  device=dev).to(bf) for _ in range(4))
    # the stage-delta field's buffers (padded base rows Lp = 288)
    lp = (L + 31) // 32 * 32
    ucodes = torch.empty(B * lp, C, dtype=torch.int8, device=dev)
    us = torch.empty(B * lp, device=dev)
    part = torch.empty(B * lp, -(-3 * C // 256), device=dev)
    cq18 = torch.empty(B * lp, 3 * C, dtype=torch.int8, device=dev)
    cs18 = torch.empty(B * lp, device=dev)
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
    # rows 23-25's pieces: the codes of a stage delta, its hidden codes
    dcodes = torch.randint(-127, 128, (rows, C), generator=g, device=dev,
                           dtype=torch.int8)
    dsr = torch.full((rows,), 1e-3, device=dev)
    hq = torch.empty(rows, hid, dtype=torch.int8, device=dev)
    hsc = torch.full((rows, 4), 1e-3, device=dev)
    hzp = torch.full((rows, 4), 0.1, device=dev)
    # rows 20-22's workspace (rows 20 and 22's, the larger) and their pieces'
    # outputs: the row codes and scales, two [rows, hid] int8 codes (the
    # cache, the hidden) and three [rows, 4] f32 scales
    bws = torch.empty(sum(-(-n // 256) * 256 for n in base_ws_sizes(
        rows, C, hid, 4, "grad")), dtype=torch.uint8, device=dev)
    bcodes, bsr = torch.empty_like(dcodes), torch.empty_like(dsr)
    bq, bq2 = (torch.randint(-127, 128, (rows, hid), generator=g, device=dev,
                             dtype=torch.int8) for _ in range(2))
    bsc = [torch.full((rows, 4), v, device=dev) for v in (1e-3, 1e-3, 0.1)]
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    w8lib = _build.load("mlp_w8") if a.source == "mlp_bf16" else None

    def bf16_ln():
        return w8lib.uspace_w8_ln_rows(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), xln_rows.data_ptr(),
            rows, C, 1e-5, s)

    def bf16_fc1(lib, rows_in):
        return lib.uspace_bf16_fc1(rows_in.data_ptr(), w1h.data_ptr(),
                                   b1.data_ptr(), h_rows.data_ptr(), rows, C,
                                   hid, s)

    def bf16_fc2(lib, res):
        return lib.uspace_bf16_fc2(
            h_rows.data_ptr(), w2h.data_ptr(), b2.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(), rows,
            hid, C, s)

    calls = {
        "packed_attention": lambda lib: lib.uspace_packed_attention(
            qkv.data_ptr(), out.data_ptr(), B, L, H, 64, 0.125,
            s),
        "qkvproj_attention": lambda lib: lib.uspace_qkvproj_attention(
            x.data_ptr(), w.data_ptr(), qkv_ws.data_ptr(), out.data_ptr(), B,
            L, H, 64, 0.125, s),
        "ln_qkvproj_attention": lambda lib: lib.uspace_ln_qkvproj_attention(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
            xln_ws.data_ptr(), qkv_ws.data_ptr(), out.data_ptr(), B, L, H, 64,
            0.125, 1e-5, s),
        "ln_rows": lambda lib: lib.uspace_ln_rows(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), xln_ws.data_ptr(),
            B * L, C, 1e-5, s),
        # w as the [3C, C] rows of a torch Linear weight
        "qkv_gemm": lambda lib: lib.uspace_qkv_gemm(
            xln_ws.data_ptr(), w.data_ptr(), qkv_ws.data_ptr(), B * L, 3 * C,
            C, s),
        "packed_attention_bwd": lambda lib: lib.uspace_packed_attention_bwd(
            qkv_t.data_ptr(), do_t.data_ptr(), dqkv.data_ptr(),
            stats.data_ptr(), TRAIN_B, L, H, 64, 0.125, s),
        "ln_qkvproj_attention_int8":
            lambda lib: lib.uspace_ln_qkvproj_attention_int8(
                x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q.q.data_ptr(),
                q.scale.data_ptr(), codes.data_ptr(), sr.data_ptr(),
                qkv_ws.data_ptr(), out.data_ptr(), B, L, H, 64, 0.125, 1e-5,
                s),
        # row 5's pieces before its core (row 1's kernel, "packed_attention")
        "ln_row_codes": lambda lib: lib.uspace_ln_row_codes(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), codes.data_ptr(),
            sr.data_ptr(), rows, C, 1e-5, s),
        "qkv_gemm_int8": lambda lib: lib.uspace_qkv_gemm_int8(
            codes.data_ptr(), sr.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), qkv_ws.data_ptr(), rows, 3 * C, C, s),
        "mlp_int8": lambda lib: lib.uspace_mlp_int8(x.data_ptr(), *mw, s),
        # row 17's two GEMMs through their h workspace
        "mlp_w8": lambda lib: lib.uspace_mlp_w8(
            x.data_ptr(), *w8[:6], h_rows.data_ptr(), *w8[6:], s),
        "ln_mlp_w8": lambda lib: lib.uspace_ln_mlp_w8(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), *w8[:6],
            xln_rows.data_ptr(), h_rows.data_ptr(), *w8[6:], 1e-5, s),
        # row 16's three pieces
        "w8_ln_rows": lambda lib: lib.uspace_w8_ln_rows(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), xln_rows.data_ptr(),
            rows, C, 1e-5, s),
        "w8_fc1": lambda lib: lib.uspace_w8_fc1(
            xln_rows.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(),
            b1.data_ptr(), h_rows.data_ptr(), rows, C, hid, s),
        "w8_fc2": lambda lib: lib.uspace_w8_fc2(
            h_rows.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
            b2.data_ptr(), x.data_ptr(), out.data_ptr(), rows, hid, C, s),
        # rows 12 and 13: their pieces in sequence (row 13's LN pass is
        # mlp_w8.cu's)
        "mlp_bf16": lambda lib: bf16_fc1(lib, x) or bf16_fc2(lib, None),
        "ln_mlp_bf16": lambda lib: (bf16_ln() or bf16_fc1(lib, xln_rows)
                                    or bf16_fc2(lib, x)),
        # rows 12 and 13's GEMMs (fc2 as row 13's, with the residual)
        "bf16_fc1": lambda lib: bf16_fc1(lib, xln_rows),
        "bf16_fc2": lambda lib: bf16_fc2(lib, x),
        "row_codes": lambda lib: lib.uspace_row_codes(
            x.data_ptr(), codes.data_ptr(), sr.data_ptr(), rows, C, s),
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
        "flash_attention": lambda lib: lib.uspace_flash_attention(
            q9.data_ptr(), k9.data_ptr(), v9.data_ptr(), o9.data_ptr(), 50, 8,
            4096, 32, 32 ** -0.5, s),
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
        # row 18 after its code pass: the GEMM's two passes, and the C
        # entry that chains them with row 1's core
        "qkv_amax": lambda lib: lib.uspace_qkv_amax(
            ucodes.data_ptr(), us.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), part.data_ptr(), B * lp, 3 * C, C, s),
        "qkv_code": lambda lib: lib.uspace_qkv_code(
            ucodes.data_ptr(), us.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), part.data_ptr(), cq18.data_ptr(),
            cs18.data_ptr(), qkvd.data_ptr(), B * lp, L, lp, 3 * C, C, s),
        "base_attn": lambda lib: lib.uspace_base_attn(
            ucodes.data_ptr(), us.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), part.data_ptr(), cq18.data_ptr(),
            cs18.data_ptr(), qkvd.data_ptr(), out.data_ptr(), B, L, lp, H,
            64, 0.125, s),
        "qkv_delta": lambda lib: lib.uspace_qkv_delta(
            dcodes.data_ptr(), dsr.data_ptr(), q.q.data_ptr(),
            q.scale.data_ptr(), cq.data_ptr(), cs.data_ptr(), qkvd.data_ptr(),
            rows, L, lp, 3 * C, C, s),
        "xm_delta": lambda lib: lib.uspace_xm_delta(
            dcodes.data_ptr(), dsr.data_ptr(), qp.q.data_ptr(),
            qp.scale.data_ptr(), x1.data_ptr(), x.data_ptr(), x.data_ptr(),
            out.data_ptr(), rows, C, C, s),
        "base_mlp_grad": lambda lib: lib.uspace_base_mlp_grad(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            out.data_ptr(), m_out.data_ptr(), gp_q.data_ptr(),
            gp_s.data_ptr(), bws.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "base_mlp_e": lambda lib: lib.uspace_base_mlp_e(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            out.data_ptr(), m_out.data_ptr(), e_q.data_ptr(),
            e_s.data_ptr(), bws.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "base_mlp_eg": lambda lib: lib.uspace_base_mlp_eg(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            out.data_ptr(), m_out.data_ptr(), e_q.data_ptr(),
            e_s.data_ptr(), g_q.data_ptr(), g_s.data_ptr(), g_z.data_ptr(),
            bws.data_ptr(), rows, C, hid, 4, 1e-5, s),
        # rows 21-22's pieces: the f32 code pass, each fc1, fc2 with m (on
        # buffers of their own, so the caches above stay as they are)
        "base_mlp_codes": lambda lib: lib.uspace_base_mlp_codes(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), bcodes.data_ptr(),
            bsr.data_ptr(), rows, C, 1e-5, s),
        "base_fc1_grad": lambda lib: lib.uspace_base_fc1_grad(
            dcodes.data_ptr(), dsr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), bq2.data_ptr(),
            bsc[0].data_ptr(), bq.data_ptr(), bsc[1].data_ptr(),
            bsc[2].data_ptr(), rows, C, hid, 4, s),
        "base_fc1_eg": lambda lib: lib.uspace_base_fc1_eg(
            dcodes.data_ptr(), dsr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), bq2.data_ptr(),
            bsc[0].data_ptr(), bq.data_ptr(), bsc[1].data_ptr(),
            bsc[2].data_ptr(), rows, C, hid, 4, s),
        "base_fc2": lambda lib: lib.uspace_base_fc2(
            bq.data_ptr(), bsc[1].data_ptr(), bsc[2].data_ptr(),
            q2.q.data_ptr(), q2.scale.data_ptr(), b2.data_ptr(),
            cs4.data_ptr(), x.data_ptr(), out.data_ptr(), m_out.data_ptr(),
            rows, C, hid, 4, s),
        # rows 25, 23 and 24's fc1 and their fc2 after the code pass (row
        # 19's ln_delta_codes)
        "delta_fc1_exact": lambda lib: lib.uspace_delta_fc1_exact(
            dcodes.data_ptr(), dsr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), e_q.data_ptr(), e_s.data_ptr(),
            hq.data_ptr(), hsc.data_ptr(), rows, C, hid, 4, s),
        "delta_fc1_lin": lambda lib: lib.uspace_delta_fc1_lin(
            dcodes.data_ptr(), dsr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), gp_q.data_ptr(), gp_s.data_ptr(),
            hq.data_ptr(), hsc.data_ptr(), rows, C, hid, 4, s),
        "delta_fc1_g": lambda lib: lib.uspace_delta_fc1_g(
            dcodes.data_ptr(), dsr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), e_q.data_ptr(), e_s.data_ptr(),
            g_q.data_ptr(), g_s.data_ptr(), g_z.data_ptr(), hq.data_ptr(),
            hsc.data_ptr(), rows, C, hid, 4, s),
        "delta_fc2": lambda lib: lib.uspace_delta_fc2(
            hq.data_ptr(), hsc.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), m_out.data_ptr(), x.data_ptr(),
            out.data_ptr(), rows, C, hid, 4, s),
        # row 15: its code pass, its GEMMs after it, the three chained
        "mlp_int8_codes": lambda lib: lib.uspace_mlp_int8_codes(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), dcodes.data_ptr(),
            dsr.data_ptr(), rows, C, 1e-5, s),
        "ln_mlp_int8": lambda lib: lib.uspace_ln_mlp_int8(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(),
            dcodes.data_ptr(), dsr.data_ptr(), hq.data_ptr(), hsc.data_ptr(),
            hzp.data_ptr(), out.data_ptr(), rows, C, hid, 4, 1e-5, s),
        "mlp_int8_fc1": lambda lib: lib.uspace_mlp_int8_fc1(
            dcodes.data_ptr(), dsr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), hq.data_ptr(), hsc.data_ptr(),
            hzp.data_ptr(), rows, C, hid, 4, s),
        "mlp_int8_fc2": lambda lib: lib.uspace_mlp_int8_fc2(
            hq.data_ptr(), hsc.data_ptr(), hzp.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), cs4.data_ptr(), x.data_ptr(),
            out.data_ptr(), rows, C, hid, 4, s),
    })
    timed = set(_build.SIGNATURES[a.source])
    if a.source == "mlp_bf16":  # the ops that its pieces make up
        timed |= {"uspace_mlp_bf16", "uspace_ln_mlp_bf16"}
    row18 = {k: calls[k] for k in ("qkv_amax", "qkv_code", "base_attn")}
    calls = {k: f for k, f in calls.items() if f"uspace_{k}" in timed}

    def time_ms(call, lib):
        """Device ms a call (CUDA events) and host us a call (the wall
        time of the loop, which only enqueues: the card is still busy with
        its first calls when the last is issued)."""
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(a.iters):
            if call(lib):
                raise RuntimeError("kernel launch failed")
        host = time.perf_counter() - t0
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / a.iters, host * 1e6 / a.iters

    order = ["base", "new", "new", "base"] * ((a.pairs + 1) // 2)
    for name, call in calls.items():
        sides = (order if hasattr(libs["base"], f"uspace_{name}")
                 and name not in NEW_INTERFACE
                 else ["new"] * (len(order) // 2))
        runs = [(side, *time_ms(call, libs[side])) for side in sides]
        print(json.dumps({
            "kernel": name, "card": torch.cuda.get_device_name(0),
            **{f"{b}_{k}": [r[i] for r in runs if r[0] == b]
               for b in ("base", "new") for i, k in ((1, "ms"), (2, "host_us"))}
        }), flush=True)
    if a.source == "attention":
        gemm_k_sweep(libs["new"], s, time_ms)
        if hasattr(libs["base"], "uspace_base_attn"):
            # row 18 of both builds on the same codes: the amax partials,
            # cache codes, scales, bf16 buffer and output compared, each
            # filled with a value no build writes before each run
            got = {}
            for side in ("base", "new"):
                for t in (part, cq18, cs18, qkvd, out):
                    t.fill_(-128 if t.dtype == torch.int8 else float("nan"))
                if calls["base_attn"](libs[side]):
                    raise RuntimeError("kernel launch failed")
                torch.cuda.synchronize()
                got[side] = [t.clone() for t in (part, cq18, cs18, qkvd, out)]
            print(json.dumps({"base_attn_bit_equal": all(
                torch.equal(u, v) for u, v in zip(got["base"], got["new"])),
                "card": torch.cuda.get_device_name(0)}), flush=True)
    if a.source == "delta_attention":  # row 18's passes, this checkout's
        att = _build.load("attention")
        for name, call in row18.items():
            ms, host = time_ms(call, att)
            print(json.dumps({"kernel": name, "card":
                              torch.cuda.get_device_name(0), "new_ms": [ms],
                              "new_host_us": [host]}), flush=True)
    if a.source == "mlp_bf16":  # row 13's LN pass; what fc1's GELU costs;
        # row 10's projection (fc2 at N = K = C with x, a cluster of two)
        print(json.dumps({
            "ln_pass_ms": time_ms(lambda _: bf16_ln(), None)[0],
            "fc1_gemm_with_fc2_epilogue_ms": time_ms(
                lambda lib: lib.uspace_bf16_fc2(
                    xln_rows.data_ptr(), w1h.data_ptr(), b1.data_ptr(), None,
                    h_rows.data_ptr(), rows, C, hid, s), libs["new"])[0],
            "row10_proj_ms": time_ms(
                lambda lib: lib.uspace_bf16_fc2(
                    x.data_ptr(), wp.data_ptr(), b2.data_ptr(), x.data_ptr(),
                    out.data_ptr(), rows, C, C, s), libs["new"])[0],
            "card": torch.cuda.get_device_name(0)}), flush=True)
    if a.source == "mlp_w8":  # row 17's pieces: fc1 on x, fc2 without x
        print(json.dumps({
            "row17_fc1_ms": time_ms(lambda lib: lib.uspace_w8_fc1(
                x.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(),
                b1.data_ptr(), h_rows.data_ptr(), rows, C, hid, s),
                libs["new"])[0],
            "row17_fc2_ms": time_ms(lambda lib: lib.uspace_w8_fc2(
                h_rows.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
                b2.data_ptr(), None, out.data_ptr(), rows, hid, C, s),
                libs["new"])[0],
            "card": torch.cuda.get_device_name(0)}), flush=True)
    if a.source == "attention_fwd":
        fwd_agreement(libs, s, time_ms)
    if a.source == "fused_attention_bwd":
        for name, call in calls.items():
            kernel_split(name, call, {k: lib for k, lib in libs.items()
                                      if hasattr(lib, f"uspace_{name}")},
                         a.iters)
    from ..ops import attention, mlp
    wrappers = {
        "attention": ("ln_qkvproj_attention_int8", lambda: attention._int8_kernel(
            x, q, H, 0.125, (lns, lnb, 1e-5))),
        "attention_fwd": ("attention_fwd", lambda: attention._fwd_kernel(
            q7, k7, v7, 32 ** -0.5)),
        "fused_attention_bwd": ("packed_attention_bwd",
                                lambda: attention._packed_bwd_kernel(
                                    qkv_t, do_t, H, 0.125)),
        "mlp_w8": ("mlp_w8", lambda: mlp._mlp_w8_kernel(
            x.reshape(rows, C), q1, b1, q2, b2)),
        "mlp_bf16": ("ln_mlp_bf16", lambda: mlp._mlp_bf16_kernel(
            x.reshape(rows, C), w1h.t(), b1, w2h.t(), b2, (lns, lnb, 1e-5))),
    }
    if a.source in wrappers:
        wrapper_host(*wrappers[a.source], time_ms)


def gemm_k_sweep(lib, stream, time_ms) -> None:
    """This checkout's int8 and bf16 wgmma projections at M = B*L, N = 3C
    over K = 256 .. 2048 (how much of a call K does not move), with
    torch._int_mm (int32 out) beside them, one JSON line a K."""
    g = torch.Generator(device="cuda").manual_seed(2)
    m, n = B * L, 3 * C
    for k in (256, 512, 1024, 2048):
        a8, w8 = (torch.randint(-127, 128, (r, k), generator=g, device="cuda",
                                dtype=torch.int8) for r in (m, n))
        ab, wb = (torch.randn(r, k, generator=g, device="cuda").bfloat16()
                  for r in (m, n))
        sr = torch.rand(m, generator=g, device="cuda")
        ws = torch.rand(n, generator=g, device="cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        row = {"k_sweep": k, "card": torch.cuda.get_device_name(0)}
        row["qkv_gemm_int8_ms"] = time_ms(lambda lb: lb.uspace_qkv_gemm_int8(
            a8.data_ptr(), sr.data_ptr(), w8.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, n, k, stream), lib)[0]
        row["qkv_gemm_ms"] = time_ms(lambda lb: lb.uspace_qkv_gemm(
            ab.data_ptr(), wb.data_ptr(), out.data_ptr(), m, n, k, stream),
            lib)[0]
        row["int_mm_ms"] = time_ms(
            lambda _: torch._int_mm(a8, w8.t()) is None, None)[0]
        print(json.dumps(row), flush=True)


def kernel_split(name, call, libs, iters) -> None:
    """Device ms a call of each kernel that the entry point ``name``
    launches, each build (torch.profiler over ``iters`` calls after a
    warm-up), one JSON line."""
    row = {"kernels_of": name, "card": torch.cuda.get_device_name(0)}
    for side, lib in libs.items():
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                call(lib)
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        row[side] = split
    print(json.dumps(row), flush=True)


def wrapper_host(name, fn, time_ms) -> None:
    """The host's time a call of this checkout's Python wrapper ``fn``
    beside its device time, one JSON line."""
    runs = [time_ms(lambda _: fn() is None, None) for _ in range(4)]
    print(json.dumps({"wrapper": name, "card": torch.cuda.get_device_name(0),
                      "ms": [r[0] for r in runs],
                      "host_us": [r[1] for r in runs]}), flush=True)


def fwd_agreement(libs, stream, time_ms) -> None:
    """Each build of the [B, H, L, D] kernel against its twin at
    chip_smoke.py's phase-3 shapes: max-abs, rel-L2, ms and host us a
    call (base, new, new, base), one JSON line a shape."""
    from ..ops.attention import attention_plain
    g = torch.Generator(device="cuda").manual_seed(1234)
    for b, h, l, d in ((50, 8, 1024, 32), (50, 4, 1024, 64), (50, 8, 600, 32)):
        q, k, v = (torch.randn(b, h, l, d, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        ref = attention_plain(q, k, v, d ** -0.5).double()
        o = torch.empty_like(q)

        def call(lib):
            return lib.uspace_attention_fwd(q.data_ptr(), k.data_ptr(),
                                            v.data_ptr(), o.data_ptr(), b, h,
                                            l, d, d ** -0.5, stream)
        row = {"shape": [b, h, l, d]}
        for side, lib in libs.items():
            if call(lib):
                raise RuntimeError("kernel launch failed")
            err = o.double() - ref
            row[side] = {"max_abs": float(err.abs().max()),
                         "rel_l2": float(err.norm() / ref.norm()), "ms": [],
                         "host_us": []}
        for side in ("base", "new", "new", "base"):
            ms, host = time_ms(call, libs[side])
            row[side]["ms"].append(ms)
            row[side]["host_us"].append(host)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
