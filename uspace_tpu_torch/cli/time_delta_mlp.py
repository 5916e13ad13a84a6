"""The delta MLP rows' pieces on the card at the main path's shape (12850
rows, C 1024, hidden 4096, seeded inputs, the caches from the base
kernels of rows 21 and 22): row 19's code pass, each row's fc1 (rows 25,
23 and 24: ``exact``, ``lin``, ``g``) and fc2 timed apart, and each row's
whole wrapper; the pieces of the stage-delta base rows 22 and 21 (the f32
code pass, ``base_fc1_grad``, ``base_fc1_eg``, ``base_fc2`` with m, each
row's C entry and wrapper, and row 20's, which runs row 21's pieces; each
fc1's epilogue apart from the GEMM
skeleton as its time less that of row 23's fc1 on the same codes, whose
epilogue is one product a value: ``epilogue_over_lin_ms``); the pieces of
the W8A8 MLP sub-block (row 15: the code pass, fc1, fc2, the C entry that
chains them, the wrapper, and row 16's wrapper beside it) and of the
stage-delta attention halves at B = 50, L = 257 (row 18: the padded LN1
code pass, the GEMM's pass A and pass B, row 1's core, the C entry that
chains the last three, the wrapper; row 19 after the code pass above: the
qkv GEMM on the padded cache, row 1's core, the difference codes, the xm
GEMM, the wrapper); then fc1 and fc2 of other builds of
``delta_mlp.cu`` (paths given as arguments, this checkout's C interface)
timed alternating with this checkout's, their codes, scales and outputs
compared with this checkout's bit for bit (rows 22 and 21's fc1, and row
15's fc1 and C entry, too). One JSON line a piece and a build; CUDA
events, 50 calls after 3 queued behind a spin of the card, so that a
launcher's host time does not count. Needs a CUDA card.

    python -m uspace_tpu_torch.cli.time_delta_mlp [variant.cu ...]
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

import torch

from ..ops import _build, quant
from ..ops import delta as dops
from ..ops import mlp as mops
from .kernel_ab import _load

B, L, C = 50, 257, 1024
ROWS, HIDDEN, STRIPS = B * L, 4 * C, 4
MODES = ("exact", "lin", "g")  # rows 25, 23, 24
NAMES = (("grad", "grad"), ("e+g", "eg"))  # rows 22, 21: mode, printed name
SPIN_CYCLES = 50_000_000  # about 25 ms at the H100's 1.98 GHz


def time_ms(fn, arg=None, iters=50):
    """Device ms a call (CUDA events) and host us a call. The timed calls
    queue behind a spin of the card (about 25 ms), so a Python launcher
    whose host time exceeds its piece's device time does not count in the
    device time."""
    for _ in range(3):
        fn(arg)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        if fn(arg):
            raise RuntimeError("launch failed")
    host = (time.perf_counter() - t0) / iters * 1e6
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters, host


def main(argv=None) -> None:
    paths = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("time_delta_mlp needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    xb = randn(ROWS, C)
    x = (xb.float() + randn(ROWS, C, std=0.01, dtype=f32)).to(torch.bfloat16)
    lns, lnb = 1 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1, dtype=f32)
    w1f = randn(HIDDEN, C, std=0.02, dtype=f32).t()  # the model's layout
    w2f = randn(C, HIDDEN, std=0.02, dtype=f32).t()
    q1, q2 = quant.quantized_weight(w1f), quant.quantized_weight(w2f)
    b1, b2 = randn(HIDDEN, std=0.02, dtype=f32), randn(C, std=0.02, dtype=f32)
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    with torch.no_grad():
        _, e_q, e_s, m_e, *gc = dops.base_mlp_block(xb, *w, mode="e+g")
        _, gp_q, gp_s, m_g = dops.base_mlp_block(xb, *w, mode="grad")
    # each row's cache as its fc1 reads it, its m_b, and its wrapper's
    # keyword arguments
    caches = {"exact": ((e_q, e_s), m_e, {}),
              "lin": ((gp_q, gp_s), m_g, dict(grad=True)),
              "g": ((e_q, e_s, *gc), m_e, dict(gelu_cache=tuple(gc)))}
    dw = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    codes = torch.empty(ROWS, C, dtype=torch.int8, device=dev)
    sr = torch.empty(ROWS, device=dev)
    hq = {m: torch.empty(ROWS, HIDDEN, dtype=torch.int8, device=dev)
          for m in MODES}
    hsc = {m: torch.empty(ROWS, STRIPS, device=dev) for m in MODES}
    out = torch.empty_like(x)
    da, dm = _build.load("delta_attention"), _build.load("delta_mlp")

    def code_pass(_=None):
        return da.uspace_ln_delta_codes(
            x.data_ptr(), xb.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            codes.data_ptr(), sr.data_ptr(), ROWS, C, 1e-5, s)

    def fc1(mode, lib, hq_=None, hsc_=None):
        hq_ = hq[mode] if hq_ is None else hq_
        hsc_ = hsc[mode] if hsc_ is None else hsc_
        return getattr(lib, f"uspace_delta_fc1_{mode}")(
            codes.data_ptr(), sr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), *(t.data_ptr() for t in caches[mode][0]),
            hq_.data_ptr(), hsc_.data_ptr(), ROWS, C, HIDDEN, STRIPS, s)

    def fc2(mode, lib, out_=out):
        return lib.uspace_delta_fc2(
            hq[mode].data_ptr(), hsc[mode].data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), caches[mode][1].data_ptr(), x.data_ptr(),
            out_.data_ptr(), ROWS, C, HIDDEN, STRIPS, s)

    def wrapper(mode):
        with torch.no_grad():
            dops.delta_mlp_block(x, xb, *caches[mode][0][:2],
                                 caches[mode][1], *dw, **caches[mode][2])

    card = torch.cuda.get_device_name(0)
    code_pass()
    ref = {}
    for mode in MODES:
        fc1(mode, dm)
        fc2(mode, dm)
        ref[mode] = (hq[mode].clone(), hsc[mode].clone(), out.clone())
    pieces = [("code_pass", code_pass, None)]
    for mode in MODES:
        pieces += [(f"fc1_{mode}", lambda lib, m=mode: fc1(m, lib), dm),
                   (f"fc2_{mode}", lambda lib, m=mode: fc2(m, lib), dm),
                   (f"wrapper_{mode}", wrapper, mode)]
    base = BaseMlpRows(dev, lns, lnb, xb, q1, b1, q2, b2)
    pieces += base.pieces()
    r15_19, r15_out = row15_18_19_pieces(randn, dev, lns, lnb, x, xb, w1f,
                                         b1, w2f, b2)
    pieces += r15_19
    # row 15's fc1 and C entry, also timed on the other builds
    r15 = [(name, fn) for name, fn, _ in r15_19
           if name in ("r15_fc1", "r15_c_entry")]
    got = {}
    for name, fn, arg in pieces:
        ms, host = time_ms(fn, arg)
        got[name] = ms
        print(json.dumps({"piece": name, "ms": ms, "host_us": host,
                          "card": card}), flush=True)
    for mode in ("grad", "eg"):  # the epilogue apart from the skeleton
        print(json.dumps({"piece": f"base_fc1_{mode}",
                          "epilogue_over_lin_ms":
                          got[f"base_fc1_{mode}"] - got["fc1_lin"],
                          "card": card}), flush=True)
    for path in paths:
        name = Path(path).stem
        lib = _load("delta_mlp", path,
                    str(_build.BUILD_DIR / f"var_{name}.so"))
        row = {"variant": name, "card": card}
        for mode, label in NAMES:
            row[f"base_fc1_{label}_bit_equal"] = base.fc1_bit_equal(mode, lib)
        for piece, fn in r15:
            fn(dm)
            torch.cuda.synchronize()
            want = [t.clone() for t in r15_out]
            fn(lib)
            torch.cuda.synchronize()
            row[f"{piece}_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(r15_out, want))
        for mode in MODES:
            hq_v, hsc_v, out_v = (torch.empty_like(t) for t in ref[mode])
            fc1(mode, lib, hq_v, hsc_v)
            torch.cuda.synchronize()
            row[f"fc1_{mode}_bit_equal"] = (torch.equal(hq_v, ref[mode][0])
                                            and torch.equal(hsc_v,
                                                            ref[mode][1]))
            fc2(mode, lib, out_v)
            torch.cuda.synchronize()
            row[f"fc2_{mode}_bit_equal"] = torch.equal(out_v, ref[mode][2])
        for piece, fn, n in [(f"fc1_{m}", lambda lb, m=m: fc1(m, lb), 2)
                             for m in MODES] + [
                (f"base_fc1_{label}", lambda lb, m=m: base.fc1(m, lb), 2)
                for m, label in NAMES] + [
                ("fc2", lambda lb: fc2("exact", lb), 1)] + [
                (piece, fn, 2) for piece, fn in r15]:
            times = {"this": [], name: []}
            for side in ("this", name, name, "this") * n:
                times[side].append(time_ms(fn, dm if side == "this"
                                           else lib)[0])
            row[f"{piece}_ms"] = times
        print(json.dumps(row), flush=True)


class BaseMlpRows:
    """Rows 22 and 21's pieces at the main path's shape on x_b, each through
    its ``ops.delta`` launcher into buffers made here: the f32 code pass,
    each fc1, fc2 with m; each row's C entry (one workspace) and wrapper,
    and row 20's (``"e"``: row 21's pieces, its affine codes in the
    workspace)."""

    def __init__(self, dev, lns, lnb, x, q1, b1, q2, b2):
        i8, f32 = torch.int8, torch.float32
        self.lns, self.lnb, self.x = lns, lnb, x
        self.q1, self.b1, self.q2, self.b2 = q1, b1, q2, b2
        self.colsum = q2.colsums(STRIPS)
        self.codes = (torch.empty(ROWS, C, dtype=i8, device=dev),
                      torch.empty(ROWS, device=dev))
        # each row's fc1 outputs: two [ROWS, HIDDEN] codes, three scales
        self.out1 = {m: [torch.empty(ROWS, HIDDEN, dtype=i8, device=dev),
                         torch.empty(ROWS, STRIPS, dtype=f32, device=dev),
                         torch.empty(ROWS, HIDDEN, dtype=i8, device=dev),
                         torch.empty(ROWS, STRIPS, dtype=f32, device=dev),
                         torch.empty(ROWS, STRIPS, dtype=f32, device=dev)]
                     for m in ("grad", "e+g")}
        self.out2 = (torch.empty_like(x), torch.empty_like(x))
        self.ws = dops._base_workspace(dev, dops.base_ws_sizes(
            ROWS, C, HIDDEN, STRIPS, "grad"))
        self.codes_pass()
        for mode in ("grad", "e+g"):
            self.fc1(mode)
        torch.cuda.synchronize()
        self.ref = {m: [t.clone() for t in self.out1[m]]
                    for m in ("grad", "e+g")}

    def codes_pass(self, _=None):
        dops._base_codes_kernel(self.x, self.lns, self.lnb, 1e-5,
                                out=self.codes)

    def fc1(self, mode, lib=None, out=None):
        dops._base_fc1_kernel(*self.codes, self.q1.q, self.q1.scale, self.b1,
                              STRIPS, mode, out=out or self.out1[mode],
                              lib=lib)

    def fc1_bit_equal(self, mode, lib) -> bool:
        out = [torch.empty_like(t) for t in self.ref[mode]]
        self.fc1(mode, lib, out)
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(out, self.ref[mode]))

    def fc2(self, _=None):
        dops._base_fc2_kernel(*self.out1["grad"][2:], self.q2.q,
                              self.q2.scale, self.b2, self.colsum, self.x,
                              out=self.out2)

    def c_entry(self, mode):
        out = self.out1["grad" if mode == "grad" else "e+g"]
        cache = out if mode == "e+g" else out[:2]
        dops._base_mlp_entry(mode, self.x, self.lns, self.lnb, self.q1.q,
                             self.q1.scale, self.b1, self.q2.q,
                             self.q2.scale, self.b2, self.colsum,
                             *self.out2, (*cache, self.ws), STRIPS, 1e-5)

    def wrapper(self, mode):
        with torch.no_grad():
            dops.base_mlp_block(self.x, self.lns, self.lnb, self.q1.kn,
                                self.q1.scale, self.b1, self.q2.kn,
                                self.q2.scale, self.b2, 1e-5, mode=mode)

    def pieces(self):
        """(name, call, argument) of each piece, C entry and wrapper."""
        out = [("base_codes", self.codes_pass, None)]
        for mode, label in NAMES:
            out += [(f"base_fc1_{label}",
                     lambda _=None, m=mode: self.fc1(m), None)]
        out += [("base_fc2", self.fc2, None)]
        for mode, label in NAMES + (("e", "e"),):
            out += [(f"base_c_entry_{label}",
                     lambda _=None, m=mode: self.c_entry(m), None),
                    (f"base_wrapper_{label}", self.wrapper, mode)]
        return out


def row15_18_19_pieces(randn, dev, lns, lnb, x, xb, w1f, b1, w2f, b2):
    """(name, call, argument) of each piece of rows 15, 18 and 19 at the
    main path's shapes, each a C entry on workspaces made here (row 19's
    code pass is ``code_pass`` above; row 15's fc1 and C entry take the
    library as their argument), and each row's wrapper; and the outputs of
    row 15's fc1 and C entry."""
    f32, bf = torch.float32, torch.bfloat16
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    strips = mops.col_slices(HIDDEN)
    q1, q2 = quant.quantized_weight(w1f), quant.quantized_weight(w2f)
    colsum = q2.colsums(strips)
    with torch.no_grad():
        codes, sr = mops._int8_codes_kernel(x, lns, lnb, 1e-5)
        hq, hsc, hzp = mops._int8_fc1_kernel(codes, sr, q1, b1, strips)
    out = torch.empty_like(x)
    # row 19 at B = 50, L = 257 on a padded cache of Lp = 288 rows
    lp = dops.round_up(L, dops.SEQ_ALIGN)
    qw = quant.quantized_weight(randn(3 * C, C, std=0.02, dtype=f32).t())
    qp = quant.quantized_weight(randn(C, C, std=0.02, dtype=f32).t())
    with torch.no_grad():
        a_b, qkv_q, qkv_s = dops.base_attn_block(xb.view(B, L, C), lns, lnb,
                                                 qw.kn, qw.scale, 16, 1e-5)
        dcodes, dsr = dops._ln_delta_codes_kernel(x, xb, lns, lnb, 1e-5)
    qkv = torch.empty(ROWS, 3 * C, dtype=bf, device=dev)
    a = torch.empty(B, L, C, dtype=bf, device=dev)
    # row 18's pieces on x_b: the padded rows' codes, the amax partials,
    # the cache it writes (not the one row 19 reads) and the core's input
    xb3 = xb.view(B, L, C)
    ucodes = torch.empty(B * lp, C, dtype=torch.int8, device=dev)
    us = torch.empty(B * lp, device=dev)
    part = torch.empty(B * lp, -(-3 * C // dops.QKV_BLOCK), device=dev)
    cq = torch.empty(B * lp, 3 * C, dtype=torch.int8, device=dev)
    cs = torch.empty(B * lp, device=dev)
    qkvd = torch.empty(ROWS, 3 * C, dtype=bf, device=dev)
    xm_b, xm = randn(ROWS, C), torch.empty_like(x)
    dm, da, att = (_build.load(n) for n in (
        "delta_mlp", "delta_attention", "attention"))

    def no_grad(fn):
        def call(_=None):
            with torch.no_grad():
                fn()
        return call

    return [
        ("r15_code_pass", lambda _=None: dm.uspace_mlp_int8_codes(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), codes.data_ptr(),
            sr.data_ptr(), ROWS, C, 1e-5, s), None),
        ("r15_fc1", lambda lib: lib.uspace_mlp_int8_fc1(
            codes.data_ptr(), sr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), hq.data_ptr(), hsc.data_ptr(),
            hzp.data_ptr(), ROWS, C, HIDDEN, strips, s), dm),
        ("r15_fc2", lambda _=None: dm.uspace_mlp_int8_fc2(
            hq.data_ptr(), hsc.data_ptr(), hzp.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), colsum.data_ptr(),
            x.data_ptr(), out.data_ptr(), ROWS, C, HIDDEN, strips, s), None),
        ("r15_c_entry", lambda lib: lib.uspace_ln_mlp_int8(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), b2.data_ptr(), colsum.data_ptr(),
            codes.data_ptr(), sr.data_ptr(), hq.data_ptr(), hsc.data_ptr(),
            hzp.data_ptr(), out.data_ptr(), ROWS, C, HIDDEN, strips, 1e-5, s),
         dm),
        ("r15_wrapper", no_grad(lambda: mops.fused_mlp_block_q(
            x, lns, lnb, w1f, b1, w2f, b2)), None),
        # row 16's wrapper on the same operands: the yardstick of the host
        # time a call of an MLP sub-block's wrapper
        ("r16_wrapper", no_grad(lambda: mops.fused_mlp_block_q(
            x, lns, lnb, w1f, b1, w2f, b2, quant="w8")), None),
        ("r18_code_pass", lambda _=None: da.uspace_ln_codes(
            xb.data_ptr(), lns.data_ptr(), lnb.data_ptr(), ucodes.data_ptr(),
            us.data_ptr(), B, L, lp, C, 1e-5, s), None),
        ("r18_pass_a", lambda _=None: att.uspace_qkv_amax(
            ucodes.data_ptr(), us.data_ptr(), qw.q.data_ptr(),
            qw.scale.data_ptr(), part.data_ptr(), B * lp, 3 * C, C, s), None),
        ("r18_pass_b", lambda _=None: att.uspace_qkv_code(
            ucodes.data_ptr(), us.data_ptr(), qw.q.data_ptr(),
            qw.scale.data_ptr(), part.data_ptr(), cq.data_ptr(),
            cs.data_ptr(), qkvd.data_ptr(), B * lp, L, lp, 3 * C, C, s),
         None),
        ("r18_core", lambda _=None: att.uspace_packed_attention(
            qkvd.data_ptr(), a.data_ptr(), B, L, 16, 64, 0.125, s), None),
        ("r18_c_entry", lambda _=None: att.uspace_base_attn(
            ucodes.data_ptr(), us.data_ptr(), qw.q.data_ptr(),
            qw.scale.data_ptr(), part.data_ptr(), cq.data_ptr(),
            cs.data_ptr(), qkvd.data_ptr(), a.data_ptr(), B, L, lp, 16, 64,
            0.125, s), None),
        ("r18_wrapper", no_grad(lambda: dops.base_attn_block(
            xb3, lns, lnb, qw.kn, qw.scale, 16, 1e-5)), None),
        ("r19_qkv_gemm", lambda _=None: att.uspace_qkv_delta(
            dcodes.data_ptr(), dsr.data_ptr(), qw.q.data_ptr(),
            qw.scale.data_ptr(), qkv_q.data_ptr(), qkv_s.data_ptr(),
            qkv.data_ptr(), ROWS, L, lp, 3 * C, C, s), None),
        ("r19_core", lambda _=None: att.uspace_packed_attention(
            qkv.data_ptr(), a.data_ptr(), B, L, 16, 64, 0.125, s), None),
        ("r19_diff_codes", lambda _=None: da.uspace_diff_codes(
            a.data_ptr(), a_b.data_ptr(), dcodes.data_ptr(), dsr.data_ptr(),
            ROWS, C, s), None),
        ("r19_xm_gemm", lambda _=None: att.uspace_xm_delta(
            dcodes.data_ptr(), dsr.data_ptr(), qp.q.data_ptr(),
            qp.scale.data_ptr(), x.data_ptr(), xb.data_ptr(), xm_b.data_ptr(),
            xm.data_ptr(), ROWS, C, C, s), None),
        ("r19_wrapper", no_grad(lambda: dops.delta_attn_block(
            x.view(B, L, C), xb.view(B, L, C), qkv_q, qkv_s, a_b,
            xm_b.view(B, L, C), lns, lnb, qw.kn, qw.scale, qp.kn, qp.scale,
            16, 1e-5)), None),
    ], (hq, hsc, hzp, out)


if __name__ == "__main__":
    main()
