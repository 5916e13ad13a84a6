"""The U-ViT MLP: exact-erf GELU and the fused int8 MLP kernels, W8A8 and
weight-only (counterpart of uspace_tpu/ops/mlp.py).

The JAX field evaluates GELU with the Abramowitz–Stegun 7.1.26 erf
polynomial (|err| <= 1.5e-7), not erf itself; the port copies the
polynomial so that the two fields agree.

Fused int8 MLP (CUDA C++ for Hopper): :func:`fused_mlp_block_q` (``x +
fc2(gelu(fc1(LN2(x))))``, TPU kernel ``_mlp_kernel_int8_lnres``) and
:func:`fused_mlp` (``fc2(gelu(fc1(x)))``, ``_mlp_kernel_int8``, one block
kernel of ``csrc/mlp_int8.cu``) with ``quant=True``. Both take f32
weights, quantized once per weight value through
``ops.quant.quantized_weight``. On the card the sub-block is three
launches from one C entry (``csrc/delta_mlp.cu`` ``uspace_ln_mlp_int8``),
counted as one: a code pass (LN2 and the row codes of its bf16 rows, the
row in registers), then fc1 and fc2 as s8 wgmma GEMMs with the affine
codes of the hidden in an [R, hidden] int8 workspace and their scales and
zero points in [R, strips] ones between them. The twins are the same
pieces: :func:`mlp_int8_fc1_plain` and :func:`mlp_int8_fc2_plain` make up
:func:`ln_mlp_int8_plain` and (without the residual) :func:`mlp_int8_plain`.
Rounding sites, shared by kernel and plain twin:

- LN2 (lnres only): f32 statistics, normalised in x's dtype (bf16):
  ``(x - bf16(mu)) * bf16(rsqrt(var + eps)) * bf16(s) + bf16(b)``, each
  product and sum rounded, then f32;
- row codes ``round(x * (127 / amax))``, ``xs = amax * (1/127)``;
- per strip j of ``hidden / strips`` columns: ``f32(acc) * xs * s1 + b1``,
  GELU in f32, then per row an affine grid ``scale = max(gmax - gmin,
  1e-8) * (1/254)``, ``zp = (gmax + gmin) * 0.5``, codes ``round((g - zp)
  / scale)``;
- fc2: ``acc += f32(d_j) * scale_j + zp_j * colsum_j(W2q)``, then ``acc *
  s2 + b2`` rounded to x's dtype (and added to x in x's dtype).

The strip count, the largest <= 4 that divides the hidden width, is part of
the numerics (the JAX package's ``_call_mlp`` rule).

Weight-only int8 MLP, the ``quant="w8"`` view (``csrc/mlp_w8.cu``):
the same two entry points with ``quant="w8"`` (TPU kernels
``_mlp_kernel_w8_lnres`` and ``_mlp_kernel_w8``). The weights are the same
int8 codes and f32 column scales; activations stay in x's dtype and are
never quantized, so the field is a fixed, smooth perturbation of the bf16
one (what an adaptive solve needs). Rounding sites:

- LN2 (lnres only): as above, ``xln`` kept in x's dtype;
- per hidden strip j: ``h_j = round(gelu(f32(xln @ q1[:, j]) * s1_j +
  b1_j))`` to x's dtype, the product exact products of x's dtype with f32
  sums, the scale and bias two roundings;
- ``acc = sum_j f32(h_j @ q2[j, :])``, then ``acc * s2 + b2`` rounded to
  x's dtype (and added to x in x's dtype).

Nothing is quantized per strip here, so the strip count is only tiling: it
orders the f32 sums and changes no rounding.

bf16 MLP, the ``quant=False`` view of both entry points (the default of
:func:`fused_mlp`, as in JAX; ``csrc/mlp_bf16.cu``, TPU kernels
``_mlp_kernel_bf16_lnres`` and ``_mlp_kernel_bf16``). Rounding sites:

- LN2 (lnres only): as above, ``xln`` kept in x's dtype;
- per hidden strip j: ``h_j = round(gelu(f32(xln @ w1[:, j]) + b1_j))`` to
  x's dtype (exact products of x's dtype, f32 sums, f32 bias);
- ``acc = sum_j f32(h_j @ w2[j, :])``, then ``acc + b2`` rounded to x's
  dtype (and added to x in x's dtype).

On the card each bf16 and w8 op is a sequence of launches counted as one:
the w8 view's LN pass (lnres only), fc1 over the whole hidden width into a
bf16 workspace, fc2 over the whole hidden width. Nothing is quantized per
strip, so the strips only order f32 sums.

The JAX package sends :func:`fused_mlp` to XLA above 12 MB of bf16 weights
(``uspace_tpu/ops/mlp.py:500-510``), a TPU VMEM residency rule; that branch
has the kernel's rounding sites (f32 sums and bias, f32 GELU, a bf16
hidden, one rounding of the output), so the port launches the kernel at
every width.

Under autograd :func:`gelu_exact` saves only its input (bf16 in training):
eager autograd of the polynomial would save about a dozen f32 tensors of
the MLP's hidden width per block. Its backward recomputes the derivative
in f32 from the input, in the analytic form ``Phi(x) + x phi(x)`` over the
same polynomial.
"""

from __future__ import annotations

from typing import Dict

import torch

from ._build import (
    check_no_grad,
    check_tensor,
    cuda_stream,
    load,
    on_cpu,
    raise_on,
)
from .quant import QWeight, int_matmul, quantized_weight, row_codes, true_div

# launches of each CUDA kernel since the last reset (the CPU twin does not count)
LAUNCHES: Dict[str, int] = {"mlp_int8": 0, "ln_mlp_int8": 0, "mlp_w8": 0,
                            "ln_mlp_w8": 0, "mlp_bf16": 0, "ln_mlp_bf16": 0}

COL_SLICES = 4  # hidden strips, at most (uspace_tpu/ops/mlp.py _COL_SLICES)

_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911
_RSQRT2 = 0.7071067811865476


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz–Stegun 7.1.26 (|err| <= 1.5e-7)."""
    a1, a2, a3, a4, a5 = _A
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _P * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_f32(xf: torch.Tensor) -> torch.Tensor:
    return 0.5 * xf * (1.0 + erf_poly(xf * _RSQRT2))


def gelu_grad(xf: torch.Tensor) -> torch.Tensor:
    """d/dx GELU(x) = Phi(x) + x phi(x), Phi from the same erf polynomial
    (``uspace_tpu/ops/mlp._gelu_grad_exact``). It differs from JAX's
    autodiff of the polynomial by at most 6e-7 in f32 (the polynomial's
    own slope error) and takes about two thirds of its eager operations."""
    phi = 0.3989422804014327 * torch.exp(-0.5 * xf * xf)
    return 0.5 * (1.0 + erf_poly(xf * _RSQRT2)) + xf * phi


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_f32(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * gelu_grad(x.float())).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, evaluated in f32 and returned in x's dtype."""
    return _Gelu.apply(x)


# ---------------------------------------------------------------------------
# Fused int8 W8A8 MLP: plain twins and CUDA kernel wrappers
# ---------------------------------------------------------------------------


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def col_slices(hidden: int) -> int:
    """Largest strip count <= :data:`COL_SLICES` that divides ``hidden``
    (a count that does not divide would drop hidden units)."""
    s = COL_SLICES
    while hidden % s:
        s -= 1
    return s


def _ln_bf16_normalise(x: torch.Tensor, ln_scale: torch.Tensor,
                       ln_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LN2 of the int8 MLP kernel: f32 statistics, normalised in x's dtype
    with a rounding after each operation; returned in f32."""
    xf = x.float()
    c = x.shape[-1]
    mu = true_div(xf.sum(dim=-1, keepdim=True), c)
    var = true_div((xf * xf).sum(dim=-1, keepdim=True), c) - mu * mu
    inv = torch.rsqrt(var + eps).to(x.dtype)
    xln = ((x - mu.to(x.dtype)) * inv * ln_scale.to(x.dtype)
           + ln_bias.to(x.dtype))
    return xln.float()


def affine_codes(g: torch.Tensor):
    """A strip of fc2's input on its affine grid per row: ``(codes, scale,
    zp)`` with scale ``max(gmax - gmin, 1e-8) * (1/254)``, zp ``(gmax +
    gmin) * 0.5`` and codes ``round((g - zp) / scale)``, a division."""
    gmax = g.amax(dim=-1, keepdim=True)
    gmin = g.amin(dim=-1, keepdim=True)
    scale = torch.clamp(gmax - gmin, min=1e-8) * (1.0 / 254.0)
    zp = (gmax + gmin) * 0.5
    return torch.round((g - zp) / scale).to(torch.int8), scale, zp


def mlp_int8_fc1_plain(xq: torch.Tensor, xs: torch.Tensor, q1: QWeight,
                       b1: torch.Tensor, strips: int):
    """Twin of the int8 MLP's fc1 (``uspace_mlp_int8_fc1``): per strip j,
    ``g = GELU(f32(acc) * xs * s1 + b1)`` on its affine grid per row, from
    the row codes ``xq [R, C]`` and scales ``xs [R, 1]``. Returns ``(hq [R,
    hidden] int8, scale [R, strips], zp [R, strips])``."""
    hs = q1.q.shape[0] // strips
    b1f = b1.float()
    parts = []
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        part = int_matmul(xq, q1.q[cols].t())
        parts.append(affine_codes(
            _gelu_f32(part.float() * xs * q1.scale[cols] + b1f[cols])))
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def mlp_int8_fc2_plain(hq: torch.Tensor, scale: torch.Tensor,
                       zp: torch.Tensor, q2: QWeight, b2: torch.Tensor,
                       x: torch.Tensor, residual: bool = True) -> torch.Tensor:
    """Twin of the int8 MLP's fc2 (``uspace_mlp_int8_fc2``): the strips'
    ``f32(d_j) * scale_j + zp_j * colsum_j`` folded in order, then ``acc *
    s2 + b2`` in x's dtype, added to x with ``residual``, from fc1's ``(hq,
    scale, zp)``."""
    strips = scale.shape[1]
    hs = hq.shape[1] // strips
    colsum = q2.colsums(strips)
    acc = None
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        d = int_matmul(hq[:, cols], q2.q[:, cols].t())
        t = d.float() * scale[:, j:j + 1] + zp[:, j:j + 1] * colsum[j]
        acc = t if acc is None else acc + t
    m = (acc * q2.scale + b2.float()).to(x.dtype)
    return x + m if residual else m


def mlp_int8_plain(x: torch.Tensor, q1: QWeight, b1: torch.Tensor,
                   q2: QWeight, b2: torch.Tensor, strips: int) -> torch.Tensor:
    """Twin of the int8 MLP kernel (``_mlp_kernel_int8``): x [R, C]."""
    return mlp_int8_fc2_plain(
        *mlp_int8_fc1_plain(*row_codes(x.float()), q1, b1, strips), q2, b2,
        x, residual=False)


def ln_mlp_int8_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, q1: QWeight, b1: torch.Tensor,
                      q2: QWeight, b2: torch.Tensor, strips: int,
                      eps: float) -> torch.Tensor:
    """Twin of the int8 MLP sub-block kernel (``_mlp_kernel_int8_lnres``):
    ``x + MLP(LN2(x))`` for x [R, C], the sum in x's dtype; the code pass
    (``row_codes`` of the bf16-chain LN2), then the fc1 and fc2 twins."""
    xq, xs = row_codes(_ln_bf16_normalise(x, ln_scale, ln_bias, eps))
    return mlp_int8_fc2_plain(*mlp_int8_fc1_plain(xq, xs, q1, b1, strips),
                              q2, b2, x)


def _mlp_operands(what, x2d, q1, b1, q2, b2):
    """Check what every MLP kernel reads (x bf16 [R, C], the codes and
    scales of w1 [C, H] and w2 [H, C']) and return ``(b1, b2, out)``: the
    biases as contiguous f32 and an empty bf16 output [R, C']."""
    r, c = x2d.shape
    hidden, out_dim = q1.q.shape[0], q2.q.shape[0]
    dev = x2d.device
    if x2d.dtype != torch.bfloat16:
        raise ValueError(f"the {what} MLP kernels take bfloat16, got "
                         f"{x2d.dtype}")
    check_tensor("x", x2d, torch.bfloat16, (r, c), dev)
    check_tensor("w1 codes", q1.q, torch.int8, (hidden, c), dev)
    check_tensor("w2 codes", q2.q, torch.int8, (out_dim, hidden), dev)
    b1f = b1.to(torch.float32).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    for name, t, n in (("w1 scales", q1.scale, (hidden,)),
                       ("b1", b1f, (hidden,)),
                       ("w2 scales", q2.scale, (out_dim,)),
                       ("b2", b2f, (out_dim,))):
        check_tensor(name, t, torch.float32, n, dev)
    return b1f, b2f, torch.empty((r, out_dim), dtype=x2d.dtype, device=dev)


def _ln_operands(ln, c, out_dim, dev):
    """``(scale, bias)`` of LN2 as contiguous f32 [C], checked, for the
    LN2 + residual variants (which need out == C)."""
    if out_dim != c:
        raise ValueError("the residual needs out == C")
    lns = ln[0].to(torch.float32).reshape(-1).contiguous()
    lnb = ln[1].to(torch.float32).reshape(-1).contiguous()
    check_tensor("ln_scale", lns, torch.float32, (c,), dev)
    check_tensor("ln_bias", lnb, torch.float32, (c,), dev)
    return lns, lnb


def _check_int8_shapes(c, hidden, out_dim, strips):
    """The widths both int8 MLP routes take, refused before any launch."""
    hs = hidden // strips
    if (c % 32 or hs % 256 or hs > 1024 or c > hs or out_dim % 256):
        raise ValueError(
            f"the int8 MLP kernels take C % 32 == 0, a strip width "
            f"hidden/{strips} of 256, 512, 768 or 1024 and >= C, and an "
            f"output width that is a multiple of 256; got C={c}, "
            f"hidden={hidden}, out={out_dim}")


def _mlp_int8_kernel(x2d, q1, b1, q2, b2, strips):
    """Launch the int8 MLP kernel (``csrc/mlp_int8.cu``) on x [R, C]
    bf16."""
    r, c = x2d.shape
    hidden, out_dim = q1.q.shape[0], q2.q.shape[0]
    dev = x2d.device
    b1f, b2f, out = _mlp_operands("int8", x2d, q1, b1, q2, b2)
    _check_int8_shapes(c, hidden, out_dim, strips)
    colsum = q2.colsums(strips)
    check_tensor("colsums", colsum, torch.float32, (strips, out_dim), dev)
    raise_on(load("mlp_int8").uspace_mlp_int8(
        x2d.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(), b1f.data_ptr(),
        q2.q.data_ptr(), q2.scale.data_ptr(), b2f.data_ptr(),
        colsum.data_ptr(), out.data_ptr(), r, c, hidden, out_dim, strips,
        cuda_stream(dev)), "uspace_mlp_int8")
    LAUNCHES["mlp_int8"] += 1
    return out


def _ln_mlp_int8_kernel(x2d, ln, q1, b1, q2, b2, strips):
    """The int8 MLP sub-block on x [R, C] bf16 with ``ln = (scale, bias,
    eps)``: one C entry (``uspace_ln_mlp_int8``) that launches the code
    pass, fc1 and fc2, counted as one, through one workspace holding the
    [R, hidden] int8 hidden, the [R, C] int8 row codes, the [R] f32 row
    scales and the [R, strips] f32 hidden scales and zero points."""
    r, c = x2d.shape
    hidden, out_dim = q1.q.shape[0], q2.q.shape[0]
    dev = x2d.device
    b1f, b2f, out = _mlp_operands("int8", x2d, q1, b1, q2, b2)
    _check_int8_shapes(c, hidden, out_dim, strips)
    lns, lnb = _ln_operands(ln, c, out_dim, dev)
    colsum = q2.colsums(strips)
    check_tensor("colsums", colsum, torch.float32, (strips, c), dev)
    ws, (hq, codes, sr, hsc, hzp) = _workspace(
        dev, (r * hidden, r * c, 4 * r, 4 * r * strips, 4 * r * strips))
    raise_on(load("delta_mlp").uspace_ln_mlp_int8(
        x2d.data_ptr(), lns.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
        q1.scale.data_ptr(), b1f.data_ptr(), q2.q.data_ptr(),
        q2.scale.data_ptr(), b2f.data_ptr(), colsum.data_ptr(), codes, sr, hq,
        hsc, hzp, out.data_ptr(), r, c, hidden, strips, ln[2],
        cuda_stream(dev)), "uspace_ln_mlp_int8")
    del ws  # held until the launches are queued
    LAUNCHES["ln_mlp_int8"] += 1
    return out


def _workspace(dev, sizes):
    """One byte tensor holding workspaces of the given byte sizes, and the
    address of each, 256-byte aligned."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    ws = torch.empty(total, dtype=torch.uint8, device=dev)
    return ws, [ws.data_ptr() + o for o in offsets]


# Row 15's pieces alone, each counted by no op, for their tests and
# timings; the sub-block's wrapper checks their operands (f32 contiguous
# scales and biases, bf16 rows).


def _int8_codes_kernel(x: torch.Tensor, ln_scale: torch.Tensor,
                       ln_bias: torch.Tensor, eps: float):
    """The code pass (``uspace_mlp_int8_codes``) of x [R, C] bf16:
    ``(codes [R, C] int8, sr [R] f32)``, ``row_codes`` of the bf16-chain
    LN2 rows."""
    r, c = x.shape
    codes = torch.empty((r, c), dtype=torch.int8, device=x.device)
    sr = torch.empty((r,), dtype=torch.float32, device=x.device)
    raise_on(load("delta_mlp").uspace_mlp_int8_codes(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        codes.data_ptr(), sr.data_ptr(), r, c, eps, cuda_stream(x.device)),
        "uspace_mlp_int8_codes")
    return codes, sr


def _int8_fc1_kernel(codes: torch.Tensor, sr: torch.Tensor, q1: QWeight,
                     b1: torch.Tensor, strips: int):
    """fc1 (``uspace_mlp_int8_fc1``): ``(hq [R, hidden] int8, scale [R,
    strips], zp [R, strips])`` as :func:`mlp_int8_fc1_plain`."""
    r, c = codes.shape
    hidden = q1.q.shape[0]
    dev = codes.device
    hq = torch.empty((r, hidden), dtype=torch.int8, device=dev)
    hsc = torch.empty((r, strips), dtype=torch.float32, device=dev)
    hzp = torch.empty_like(hsc)
    raise_on(load("delta_mlp").uspace_mlp_int8_fc1(
        codes.data_ptr(), sr.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(),
        b1.data_ptr(), hq.data_ptr(), hsc.data_ptr(), hzp.data_ptr(), r, c,
        hidden, strips, cuda_stream(dev)), "uspace_mlp_int8_fc1")
    return hq, hsc, hzp


def _int8_fc2_kernel(hq: torch.Tensor, hsc: torch.Tensor, hzp: torch.Tensor,
                     q2: QWeight, b2: torch.Tensor, colsum: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """fc2 (``uspace_mlp_int8_fc2``): ``x + bf16(acc * s2 + b2)`` as
    :func:`mlp_int8_fc2_plain`."""
    r, hidden = hq.shape
    out = torch.empty_like(x)
    raise_on(load("delta_mlp").uspace_mlp_int8_fc2(
        hq.data_ptr(), hsc.data_ptr(), hzp.data_ptr(), q2.q.data_ptr(),
        q2.scale.data_ptr(), b2.data_ptr(), colsum.data_ptr(), x.data_ptr(),
        out.data_ptr(), r, q2.q.shape[0], hidden, hsc.shape[1],
        cuda_stream(hq.device)), "uspace_mlp_int8_fc2")
    return out


def _mlp_w8_core(xa: torch.Tensor, q1: QWeight, b1: torch.Tensor,
                 q2: QWeight, b2: torch.Tensor, strips: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """fc2(gelu(fc1(x))) with the w8 kernels' rounding sites, from rows
    ``xa [R, C]`` whose values are exact in ``dtype``; returns ``[R,
    out]`` in ``dtype``. int8 codes are exact in f32 (and bf16), so the f32
    products below are the kernels' exact products with f32 sums."""
    hidden = q1.q.shape[0]
    hs = hidden // strips
    xf = xa.float()
    b1f, b2f = b1.float(), b2.float()
    acc = None
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        part = torch.matmul(xf, q1.q[cols].float().t())
        h = _gelu_f32(part * q1.scale[cols] + b1f[cols]).to(dtype)
        t = torch.matmul(h.float(), q2.q[:, cols].float().t())
        acc = t if acc is None else acc + t
    return (acc * q2.scale + b2f).to(dtype)


def mlp_w8_plain(x: torch.Tensor, q1: QWeight, b1: torch.Tensor,
                 q2: QWeight, b2: torch.Tensor, strips: int) -> torch.Tensor:
    """Twin of the weight-only int8 MLP kernel (``_mlp_kernel_w8``): x [R,
    C]."""
    return _mlp_w8_core(x, q1, b1, q2, b2, strips, x.dtype)


def ln_mlp_w8_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, q1: QWeight, b1: torch.Tensor,
                    q2: QWeight, b2: torch.Tensor, strips: int,
                    eps: float) -> torch.Tensor:
    """Twin of the weight-only int8 MLP sub-block kernel
    (``_mlp_kernel_w8_lnres``): ``x + MLP(LN2(x))`` for x [R, C], the sum in
    x's dtype. ``xln`` is x's dtype (its f32 copy is exact)."""
    xln = _ln_bf16_normalise(x, ln_scale, ln_bias, eps)
    return x + _mlp_w8_core(xln, q1, b1, q2, b2, strips, x.dtype)


def _mlp_w8_kernel(x2d, q1, b1, q2, b2, ln=None):
    """Launch the weight-only int8 MLP kernels on x [R, C] bf16: fc1 and fc2
    (two wgmma GEMMs, the hidden through a bf16 workspace [R, hidden]); with
    ``ln = (scale, bias, eps)`` the LN2 + residual variant, whose three
    pieces (the LN pass, the fc1 and fc2 GEMMs) pass its rows and hidden
    through bf16 workspaces [R, C] and [R, hidden]. Either op counts one
    launch."""
    r, c = x2d.shape
    hidden, out_dim = q1.q.shape[0], q2.q.shape[0]
    dev = x2d.device
    b1f, b2f, out = _mlp_operands("w8", x2d, q1, b1, q2, b2)
    # the GEMMs' 64-deep K chunks and 128-wide weight tiles
    # (csrc/mlp_w8.cu launch_gemm); the LN pass holds a row of <= 2048
    if (c % 64 or hidden % 128 or out_dim % 128
            or (ln is not None and c > 2048)):
        raise ValueError(
            f"the w8 MLP kernels take C a multiple of 64 (up to 2048 with "
            f"LN2) and hidden and output widths that are multiples of 128; "
            f"got C={c}, hidden={hidden}, out={out_dim}")
    stream = cuda_stream(dev)
    lib = load("mlp_w8")
    weights = (q1.q.data_ptr(), q1.scale.data_ptr(), b1f.data_ptr(),
               q2.q.data_ptr(), q2.scale.data_ptr(), b2f.data_ptr())
    h = x2d.new_empty((r, hidden))
    if ln is None:
        rc = lib.uspace_mlp_w8(x2d.data_ptr(), *weights, h.data_ptr(),
                               out.data_ptr(), r, c, hidden, out_dim, stream)
        key = "mlp_w8"
    else:
        lns, lnb = _ln_operands(ln, c, out_dim, dev)
        xln = torch.empty_like(x2d)
        rc = lib.uspace_ln_mlp_w8(x2d.data_ptr(), lns.data_ptr(),
                                  lnb.data_ptr(), *weights, xln.data_ptr(),
                                  h.data_ptr(), out.data_ptr(), r, c, hidden,
                                  out_dim, ln[2], stream)
        key = "ln_mlp_w8"
    raise_on(rc, f"uspace_{key}")
    LAUNCHES[key] += 1
    return out


def _w8_ln_kernel(x: torch.Tensor, ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The LN pass of the w8 and the bf16 MLP sub-blocks alone (the bf16
    chain of LN2, its f32 sums in lane order) on x [R, C] bf16; counted by
    no op, as it is a piece of one."""
    r, c = x.shape
    check_tensor("x", x, torch.bfloat16, (r, c), x.device)
    lns, lnb = _ln_operands((ln_scale, ln_bias), c, c, x.device)
    out = torch.empty_like(x)
    raise_on(load("mlp_w8").uspace_w8_ln_rows(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), out.data_ptr(), r, c,
        eps, cuda_stream(x.device)), "uspace_w8_ln_rows")
    return out


def _w8_fc1_kernel(xln: torch.Tensor, q1: QWeight,
                   b1: torch.Tensor) -> torch.Tensor:
    """The fc1 GEMM of the w8 MLPs alone: ``bf16(gelu(f32(xln . q1^T) * s1
    + b1))`` for xln [R, C] bf16 (the LN2 rows in the sub-block, x in the
    MLP; C a multiple of 64, the hidden width of 128). Counted by no op."""
    r, c = xln.shape
    hidden = q1.q.shape[0]
    check_tensor("xln", xln, torch.bfloat16, (r, c), xln.device)
    check_tensor("w1 codes", q1.q, torch.int8, (hidden, c), xln.device)
    b1f = b1.to(torch.float32).contiguous()
    check_tensor("w1 scales", q1.scale, torch.float32, (hidden,), xln.device)
    check_tensor("b1", b1f, torch.float32, (hidden,), xln.device)
    h = xln.new_empty((r, hidden))
    raise_on(load("mlp_w8").uspace_w8_fc1(
        xln.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(), b1f.data_ptr(),
        h.data_ptr(), r, c, hidden, cuda_stream(xln.device)), "uspace_w8_fc1")
    return h


def _w8_fc2_kernel(h: torch.Tensor, q2: QWeight, b2: torch.Tensor,
                   res: torch.Tensor = None) -> torch.Tensor:
    """The fc2 GEMM of the w8 MLPs alone: ``[res +] bf16(f32(h . q2^T) * s2
    + b2)`` (the sum in bf16) for h [R, hidden] bf16 (hidden a multiple of
    64, the output width of 128); the sub-block passes x as res, the MLP
    none. Counted by no op."""
    r, hidden = h.shape
    out_dim = q2.q.shape[0]
    check_tensor("h", h, torch.bfloat16, (r, hidden), h.device)
    if res is not None:
        check_tensor("res", res, torch.bfloat16, (r, out_dim), h.device)
    check_tensor("w2 codes", q2.q, torch.int8, (out_dim, hidden), h.device)
    b2f = b2.to(torch.float32).contiguous()
    check_tensor("w2 scales", q2.scale, torch.float32, (out_dim,), h.device)
    check_tensor("b2", b2f, torch.float32, (out_dim,), h.device)
    out = h.new_empty((r, out_dim))
    raise_on(load("mlp_w8").uspace_w8_fc2(
        h.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(), b2f.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), r, hidden,
        out_dim, cuda_stream(h.device)), "uspace_w8_fc2")
    return out


def _mlp_bf16_core(xa: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, strips: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """fc2(gelu(fc1(x))) with the bf16 kernels' rounding sites, from rows
    ``xa [R, C]`` whose values are exact in ``dtype`` and weights w1 [C, H],
    w2 [H, C'] (JAX layout) rounded to ``dtype``; returns ``[R, C']`` in
    ``dtype``. The f32 products of ``dtype`` values are exact, so the
    matmuls below are the kernels' products with f32 sums."""
    hidden = w1.shape[-1]
    hs = hidden // strips
    xf = xa.float()
    w1f, w2f = w1.to(dtype).float(), w2.to(dtype).float()
    b1f, b2f = b1.float(), b2.float()
    acc = None
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        h = _gelu_f32(torch.matmul(xf, w1f[:, cols]) + b1f[cols]).to(dtype)
        t = torch.matmul(h.float(), w2f[cols])
        acc = t if acc is None else acc + t
    return (acc + b2f).to(dtype)


def mlp_bf16_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   strips: int) -> torch.Tensor:
    """Twin of the bf16 MLP kernel (``_mlp_kernel_bf16``): x [R, C], the
    weights in the JAX layout."""
    return _mlp_bf16_core(x, w1, b1, w2, b2, strips, x.dtype)


def ln_mlp_bf16_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      strips: int, eps: float) -> torch.Tensor:
    """Twin of the bf16 MLP sub-block kernel (``_mlp_kernel_bf16_lnres``):
    ``x + MLP(LN2(x))`` for x [R, C], the sum in x's dtype."""
    xln = _ln_bf16_normalise(x, ln_scale, ln_bias, eps)
    return x + _mlp_bf16_core(xln, w1, b1, w2, b2, strips, x.dtype)


def _mlp_bf16_kernel(x2d, w1, b1, w2, b2, ln=None):
    """Launch the bf16 MLP kernels on x [R, C] bf16 with w1 [C, H] and w2
    [H, C'] (JAX layout; read as their bf16 torch-layout rows, free for the
    transpose of a bf16 Linear weight); with ``ln = (scale, bias, eps)`` the
    LN2 + residual variant. Its pieces (the w8 sub-block's LN pass, then the
    fc1 and fc2 GEMMs) pass the rows and the hidden through bf16 workspaces
    [R, C] and [R, H]; the op counts one launch."""
    r, c = x2d.shape
    hidden, out_dim = w1.shape[-1], w2.shape[-1]
    if x2d.dtype != torch.bfloat16:
        raise ValueError(f"the bf16 MLP kernels take bfloat16, got "
                         f"{x2d.dtype}")
    # the GEMMs need C a multiple of 64 and hidden and output widths that are
    # multiples of 256, and the LN pass C <= 2048; C <= 1280 and the four
    # output widths are kept only as the range this wrapper has always
    # accepted, which the tests cover
    if (c % 64 or c > 1280 or hidden % 256
            or out_dim not in (256, 512, 768, 1024)):
        raise ValueError(
            f"the bf16 MLP kernels take C a multiple of 64 up to 1280, a "
            f"hidden width that is a multiple of 256 and an output width "
            f"of 256, 512, 768 or 1024; got C={c}, hidden={hidden}, "
            f"out={out_dim}")
    w1r = w1.to(torch.bfloat16).t().contiguous()
    w2r = w2.to(torch.bfloat16).t().contiguous()
    if ln is None:
        out = _bf16_fc2_kernel(_bf16_fc1_kernel(x2d, w1r, b1), w2r, b2)
        key = "mlp_bf16"
    else:
        if out_dim != c:
            raise ValueError("the residual needs out == C")
        xln = _w8_ln_kernel(x2d, ln[0], ln[1], ln[2])
        out = _bf16_fc2_kernel(_bf16_fc1_kernel(xln, w1r, b1), w2r, b2, x2d)
        key = "ln_mlp_bf16"
    LAUNCHES[key] += 1
    return out


def _bf16_fc1_kernel(x: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor) -> torch.Tensor:
    """The fc1 GEMM of the bf16 MLP: ``bf16(gelu(f32(x . w1^T) + b1))`` for
    x [R, C] bf16 (the LN2 rows in the sub-block; C a multiple of 64) and
    the torch-layout rows w1 [H, C] bf16 (H a multiple of 256). Counted by
    no op."""
    r, c = x.shape
    hidden = w1.shape[0]
    dev = x.device
    b1f = b1.to(torch.float32).contiguous()
    check_tensor("x", x, torch.bfloat16, (r, c), dev)
    check_tensor("w1", w1, torch.bfloat16, (hidden, c), dev)
    check_tensor("b1", b1f, torch.float32, (hidden,), dev)
    h = x.new_empty((r, hidden))
    raise_on(load("mlp_bf16").uspace_bf16_fc1(
        x.data_ptr(), w1.data_ptr(), b1f.data_ptr(), h.data_ptr(), r, c,
        hidden, cuda_stream(dev)), "uspace_bf16_fc1")
    return h


def _bf16_fc2_kernel(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     res: torch.Tensor = None) -> torch.Tensor:
    """The fc2 GEMM of the bf16 MLP, and the bf16 attention sub-block's
    projection: ``[res +] bf16(f32(h . w2^T) + b2)`` (the sum in bf16) for h
    [R, H] bf16 (H a multiple of 64) and the torch-layout rows w2 [C', H]
    bf16 (C' a multiple of 256; of 128 with ``res``). Counted by no op."""
    r, hidden = h.shape
    out_dim = w2.shape[0]
    dev = h.device
    b2f = b2.to(torch.float32).contiguous()
    check_tensor("h", h, torch.bfloat16, (r, hidden), dev)
    check_tensor("w2", w2, torch.bfloat16, (out_dim, hidden), dev)
    check_tensor("b2", b2f, torch.float32, (out_dim,), dev)
    if res is not None:
        check_tensor("res", res, torch.bfloat16, (r, out_dim), dev)
    out = h.new_empty((r, out_dim))
    raise_on(load("mlp_bf16").uspace_bf16_fc2(
        h.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), r, hidden,
        out_dim, cuda_stream(dev)), "uspace_bf16_fc2")
    return out


def _view(quant) -> str:
    """The MLP view of ``quant``: ``"bf16"`` (False or None), ``"w8"``
    (int8 weights only) or ``"int8"`` (W8A8: ``True`` or ``"w8a8"``)."""
    if not quant:
        return "bf16"
    if quant == "w8":
        return "w8"
    if quant is True or quant == "w8a8":
        return "int8"
    raise ValueError(f"unknown MLP view quant={quant!r}")


def fused_mlp_block_q(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      eps: float = 1e-5, quant=True) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))``, the pre-norm MLP sub-block, with int8
    W8A8 projections (``quant=True``), int8 weights and activations in x's
    dtype (``quant="w8"``) or bf16 projections (``quant=False``); w1 [C, H]
    and w2 [H, C] in the JAX layout (as ``linear.weight.t()``; f32 for the
    int8 views, whose codes are fitted on them). Inference-only."""
    view = _view(quant)
    check_no_grad(x, ln_scale, ln_bias, w1, b1, w2, b2,
                  what=f"the {view} MLP sub-block kernel")
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    strips = col_slices(w1.shape[-1])
    ln = (ln_scale, ln_bias, eps)
    if view == "bf16":
        if on_cpu(x):
            out = ln_mlp_bf16_plain(x2d, ln_scale, ln_bias, w1, b1, w2, b2,
                                    strips, eps)
        else:
            out = _mlp_bf16_kernel(x2d.contiguous(), w1, b1, w2, b2, ln)
        return out.reshape(x.shape)
    q1, q2 = quantized_weight(w1), quantized_weight(w2)
    if on_cpu(x):
        plain = ln_mlp_w8_plain if view == "w8" else ln_mlp_int8_plain
        out = plain(x2d, ln_scale, ln_bias, q1, b1, q2, b2, strips, eps)
    elif view == "w8":
        out = _mlp_w8_kernel(x2d.contiguous(), q1, b1, q2, b2, ln)
    else:
        out = _ln_mlp_int8_kernel(x2d.contiguous(), ln, q1, b1, q2, b2,
                                  strips)
    return out.reshape(x.shape)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, quant=False) -> torch.Tensor:
    """``gelu(x @ w1 + b1) @ w2 + b2`` with bf16 projections (``quant=False``,
    the default, as in JAX), int8 W8A8 projections (``quant=True``) or int8
    weights and activations in x's dtype (``quant="w8"``); x [..., C], w1
    [C, H], w2 [H, C'] (JAX layout; f32 for the int8 views).
    Inference-only."""
    view = _view(quant)
    check_no_grad(x, w1, b1, w2, b2, what=f"the {view} MLP kernel")
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    strips = col_slices(w1.shape[-1])
    out_dim = w2.shape[-1]
    if view == "bf16":
        if on_cpu(x):
            out = mlp_bf16_plain(x2d, w1, b1, w2, b2, strips)
        else:
            out = _mlp_bf16_kernel(x2d.contiguous(), w1, b1, w2, b2)
        return out.reshape(*x.shape[:-1], out_dim)
    q1, q2 = quantized_weight(w1), quantized_weight(w2)
    if on_cpu(x):
        plain = mlp_w8_plain if view == "w8" else mlp_int8_plain
        out = plain(x2d, q1, b1, q2, b2, strips)
    elif view == "w8":
        out = _mlp_w8_kernel(x2d.contiguous(), q1, b1, q2, b2)
    else:
        out = _mlp_int8_kernel(x2d.contiguous(), q1, b1, q2, b2, strips)
    return out.reshape(*x.shape[:-1], out_dim)
