"""Row 25's pieces on the card at the main path's shape (12850 rows, C 1024,
hidden 4096, seeded inputs, the caches from row 20's kernel): row 19's code
pass, fc1 and fc2 timed apart, and the whole wrapper; then fc1 and fc2 of
other builds of ``delta_mlp.cu`` (paths given as arguments, this checkout's
C interface) timed alternating with this checkout's, their codes, scales
and outputs compared with this checkout's bit for bit. One JSON line a
piece and a build; CUDA events, 50 calls after 3. Needs a CUDA card.

    python -m uspace_tpu_torch.cli.time_row25 [variant.cu ...]
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
from .kernel_ab import _load

B, L, C = 50, 257, 1024
ROWS, HIDDEN, STRIPS = B * L, 4 * C, 4


def time_ms(fn, arg=None, iters=50):
    """Device ms a call (CUDA events) and host us a call."""
    for _ in range(3):
        fn(arg)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
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
        raise SystemExit("time_row25 needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    xb = randn(ROWS, C)
    x = (xb.float() + randn(ROWS, C, std=0.01, dtype=f32)).to(torch.bfloat16)
    lns, lnb = 1 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1, dtype=f32)
    q1 = quant.quantized_weight(randn(HIDDEN, C, std=0.02, dtype=f32).t())
    q2 = quant.quantized_weight(randn(C, HIDDEN, std=0.02, dtype=f32).t())
    b1, b2 = randn(HIDDEN, std=0.02, dtype=f32), randn(C, std=0.02, dtype=f32)
    with torch.no_grad():
        _, e_q, e_s, m = dops.base_mlp_block(xb, lns, lnb, q1.kn, q1.scale, b1,
                                             q2.kn, q2.scale, b2, 1e-5)
    dw = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    codes = torch.empty(ROWS, C, dtype=torch.int8, device=dev)
    sr = torch.empty(ROWS, device=dev)
    hq = torch.empty(ROWS, HIDDEN, dtype=torch.int8, device=dev)
    hsc = torch.empty(ROWS, STRIPS, device=dev)
    out = torch.empty_like(x)
    da, dm = _build.load("delta_attention"), _build.load("delta_mlp")

    def code_pass(_=None):
        return da.uspace_ln_delta_codes(
            x.data_ptr(), xb.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            codes.data_ptr(), sr.data_ptr(), ROWS, C, 1e-5, s)

    def fc1(lib, hq_=hq, hsc_=hsc):
        return lib.uspace_delta_fc1_exact(
            codes.data_ptr(), sr.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), e_q.data_ptr(), e_s.data_ptr(), hq_.data_ptr(),
            hsc_.data_ptr(), ROWS, C, HIDDEN, STRIPS, s)

    def fc2(lib, out_=out):
        return lib.uspace_delta_fc2(
            hq.data_ptr(), hsc.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
            m.data_ptr(), x.data_ptr(), out_.data_ptr(), ROWS, C, HIDDEN,
            STRIPS, s)

    def wrapper(_=None):
        with torch.no_grad():
            dops.delta_mlp_block(x, xb, e_q, e_s, m, *dw)

    card = torch.cuda.get_device_name(0)
    code_pass()
    fc1(dm)
    fc2(dm)
    ref = (hq.clone(), hsc.clone(), out.clone())
    for name, fn, arg in (("code_pass", code_pass, None), ("fc1", fc1, dm),
                          ("fc2", fc2, dm), ("wrapper", wrapper, None)):
        ms, host = time_ms(fn, arg)
        print(json.dumps({"piece": name, "ms": ms, "host_us": host,
                          "card": card}), flush=True)
    for path in paths:
        name = Path(path).stem
        lib = _load("delta_mlp", path,
                    str(_build.BUILD_DIR / f"var_{name}.so"))
        hq_v, hsc_v, out_v = (torch.empty_like(t) for t in ref)
        fc1(lib, hq_v, hsc_v)
        fc2(lib, out_v)
        torch.cuda.synchronize()
        row = {"variant": name,
               "fc1_bit_equal": torch.equal(hq_v, ref[0])
               and torch.equal(hsc_v, ref[1]),
               "fc2_bit_equal": torch.equal(out_v, ref[2]), "card": card}
        for piece, fn, n in (("fc1", fc1, 2), ("fc2", fc2, 1)):
            times = {"this": [], name: []}
            for side in ("this", name, name, "this") * n:
                times[side].append(time_ms(fn, dm if side == "this"
                                           else lib)[0])
            row[f"{piece}_ms"] = times
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
