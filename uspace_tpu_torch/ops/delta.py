"""The fused kernels of the base-anchored stage-delta int8 field
(counterpart of ``uspace_tpu/ops/delta.py``), in its three hidden modes.

One RK step evaluates the field once in full ("base", stage 2) and emits a
read-only per-block cache; every later stage ("delta") rebuilds each
projection as ``cached + W @ q8(input_i - input_base)``, an int8 product
whose rounding step is set by the stage gap, and emits nothing. Eight
kernels, hand-written in CUDA C++ for Hopper:

- :func:`base_attn_block` (``csrc/delta_attention.cu``, TPU kernel
  ``_base_attn_cache_kernel``): ``a = attention(qkv(LN1(x)))`` in int8
  W8A8, the qkv re-coded per row (the cache ``qkv_q``/``qkv_s``) and the
  attention run on the dequantized cache, so a zero delta reproduces ``a``.
  Its four launches (counted as one): the padded LN1 code pass, then from
  one C entry ``csrc/attention.cu``'s int8 wgmma GEMM twice, pass A keeping
  each row's max |qkv| over each 256-column tile, pass B coding the same
  product with their max into the cache and the core's bf16 input, then
  row 1's core; :func:`qkv_amax_plain` and :func:`qkv_code_plain` are the
  passes' twins and, with the code pass's and row 1's, make up
  :func:`base_attn_plain`;
- :func:`delta_attn_block` (same file, ``_delta_attn_kernel``): ``qkv =
  deq(cache) + Wq q8(LN1(x) - LN1(x_b))``, attention, ``xm = (x - x_b) +
  xm_b + Wp q8(a - a_b)``; both serve every hidden mode. Its five launches
  (counted as one): the code pass of ``LN1(x) - LN1(x_b)``, the qkv GEMM
  (``csrc/attention.cu``'s int8 wgmma GEMM with the cache epilogue), row
  1's core, the codes of ``a - a_b``, the xm GEMM (the same GEMM with the
  stream epilogue); :func:`ln_delta_codes_plain`, :func:`qkv_delta_plain`
  and :func:`xm_delta_plain` are the pieces' twins and, with row 1's twin
  and ``row_codes``, make up :func:`delta_attn_plain`;
- :func:`base_mlp_block` (``csrc/delta_mlp.cu``): ``o = x + m``, ``m =
  fc2(gelu(fc1(LN2(x))))``, and the cache of its mode. ``mode="e"`` (the
  ``"exact"`` hidden mode, ``_base_mlp_cache_kernel``): ``e`` coded per row
  and strip (``e_q``/``e_s``) and GELU run on ``deq(e_q)``, so a zero delta
  reproduces ``m``; ``mode="e+g"`` (``"gelu"``,
  ``_base_mlp_cache_kernel_g``): also the affine codes fc2 read
  (``g_q``/``g_s``/``g_z``); ``mode="grad"`` (``_base_mlp_cache_kernel_gr``):
  GELU on the exact f32 hidden, ``gelu'(e)`` coded per row and strip.
  Each mode is three launches from one C entry, counted as one: the f32
  code pass of LN2(x), the mode's fc1 on wgmma with its statistics shared
  across the strip's cluster, fc2 on wgmma storing m beside x + m
  (``"e"`` runs ``"e+g"``'s, its affine codes in the workspace);
  :func:`base_codes_plain`, :func:`base_fc1_grad_plain`,
  :func:`base_fc1_eg_plain` and :func:`base_fc2_plain` are the pieces'
  twins;
- :func:`delta_mlp_block` (same file): ``m = m_b + W2 q8(dg)`` per strip,
  ``o = x + m``, with ``de = W1 q8(LN2(x) - LN2(x_b))`` and ``dg = gelu(
  deq(e_q) + de) - gelu(deq(e_q))`` (``_delta_mlp_kernel``, the default),
  ``dg = gelu(deq(e_q) + de) - deq(g_q)`` with ``gelu_cache``
  (``_delta_mlp_kernel_g``), or ``dg = de * deq(gp)`` with ``grad=True``
  (``_delta_mlp_kernel_lin``: no GELU at all). Each is three launches
  counted as one: row 19's code pass of ``LN2(x) - LN2(x_b)``
  (``csrc/delta_attention.cu``), fc1 on wgmma with the mode's dg epilogue,
  its codes per row and strip into an int8 workspace, then fc2 on wgmma
  with the strips' sums folded in order.

Rounding sites, shared by each kernel and its plain twin here:

- the LN of all eight is ``_ln_f32``: f32 sums over C, ``var = E[x^2] -
  mu^2``, ``rsqrt(var + eps)``, f32 scale and bias, never rounded to bf16
  (not the bf16 chain of the int8 MLP and sub-block kernels). The twins
  take the two sums in the kernels' order (:func:`ln_lanes`): an f32 LN
  row is coded as it is, so a sum taken in another order flips a code now
  and then and moves every output of its row;
- activations, ``e`` and ``dg`` are coded per row (per row and strip for
  the hidden) with ``round(x * (127 / amax))`` and the scale ``amax *
  (1/127)`` (``ops.quant.row_codes``, the TPU kernels' ``_rowquant``): a
  product, no clip, never ``int8_dense``'s division;
- the base MLP codes fc2's input on the affine grid of the int8 MLP kernel
  (one per row and strip, ``round((g - zp) / scale)``, a division), and
  the ``"exact"``/``"gelu"`` base runs GELU on ``f32(e_q) * e_s``, never on
  ``e``; the ``"gelu"`` delta's anchor is ``f32(g_q) * g_s + g_z``, two
  roundings; the strip count is ``ops.mlp.col_slices`` of the hidden
  width, as the JAX package's ``_mlp_call`` derives it;
- biases cancel in every delta product; residual adds round in x's dtype.

Shapes, as the JAX functions return them: ``qkv_q`` [B, Lp, 3C] int8 and
``qkv_s`` [B, Lp, 1] f32 with Lp = round_up(L, 32) (the base runs on the
rows past L as zeros, as the TPU kernel's padded block does); ``a`` [B, L,
C]; ``e_q``, ``g_q`` or ``gp_q`` [B*L, hidden] int8 and their scales (and
``g_z``) [B*L, strips] f32; ``m`` [B, L, C]. Weights come pre-quantized, in
the JAX layout: int8 ``[K, N]`` (the ``kn`` view of an
``ops.quant.QWeight``, which the kernels read without a copy) with f32
column scales ``[N]`` or ``[1, N]``.

Each wrapper launches its kernel for a CUDA tensor and uses its twin only
for a tensor on the CPU; on CUDA it never falls back. Inference-only, as in
JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import (
    check_no_grad,
    check_tensor,
    cuda_stream,
    load,
    on_cpu,
    raise_on,
)
from .attention import KERNEL_HEAD_DIMS, KERNEL_MAX_LEN, \
    packed_attention_plain
from .mlp import _gelu_f32, affine_codes, col_slices, gelu_grad
from .quant import QMAX, int_matmul, row_codes, strip_colsums, true_div

# launches of each CUDA kernel since the last reset (the CPU twin does not count)
LAUNCHES: Dict[str, int] = {"base_attn_cache": 0, "delta_attn": 0,
                            "base_mlp_grad": 0, "delta_mlp_lin": 0,
                            "base_mlp_e": 0, "base_mlp_eg": 0,
                            "delta_mlp_g": 0, "delta_mlp_exact": 0}

SEQ_ALIGN = 32  # the cache's row padding (the TPU kernels' Lp)
QKV_BLOCK = 256  # row 18's columns of one amax partial: the GEMM's tile

# the base MLP's cache of each mode: its kernel's entry point and count
BASE_MODES = {"e": "base_mlp_e", "e+g": "base_mlp_eg",
              "grad": "base_mlp_grad"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _vec(t: torch.Tensor) -> torch.Tensor:
    """A scale, bias or LN vector as contiguous f32 [N]."""
    return t.to(torch.float32).reshape(-1).contiguous()


# ---------------------------------------------------------------------------
# Plain twins (the CPU path and the tests' reference)
# ---------------------------------------------------------------------------


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 row sum of ``v [..., C]``: lane l of a warp adds,
    in order, the 8 values of each vector l + 32 i; then five butterfly
    steps add lane l ^ o for o = 16, 8, 4, 2, 1 (an f32 sum is commutative,
    so every lane ends with one value)."""
    c = v.shape[-1]
    vecs = -(-c // 256) * 32  # whole warps of 8-value vectors
    v = F.pad(v, (0, vecs * 8 - c)).reshape(*v.shape[:-1], vecs // 32, 32, 8)
    s = torch.zeros(v.shape[:-3] + (32,), dtype=v.dtype, device=v.device)
    for i in range(v.shape[-3]):
        for j in range(8):
            s = s + v[..., i, :, j]
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    return s[..., :1]


def ln_lanes(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``_ln_f32`` with its two sums taken in the kernels' order (one warp
    per row, :func:`_lane_sum`): mu = sum / C, var = sum(x^2) / C - mu^2,
    ``((x - mu) * rsqrt(var + eps)) * s + b`` in f32."""
    xf = x.float()
    c = x.shape[-1]
    mu = true_div(_lane_sum(xf), c)
    var = true_div(_lane_sum(xf * xf), c) - mu * mu
    inv = torch.rsqrt(var + eps)
    return (xf - mu) * inv * ln_scale.float() + ln_bias.float()


def base_attn_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                    num_heads: int, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Twin of ``_base_attn_cache_kernel`` as the card runs it: LN1 in f32
    of x padded with zero rows to Lp and its row codes, pass A's row amax
    partials of the int8 QKV product ``f32(acc) * us * ws``
    (:func:`qkv_amax_plain`), pass B's codes of it per row over all 3C
    columns (``qkv_q``, ``qkv_s``) with ``bf16(f32(qkv_q) * qkv_s)`` of the
    L real rows (:func:`qkv_code_plain`, in x's dtype), and the attention
    core on those."""
    b, l, c = x.shape
    lp = round_up(l, SEQ_ALIGN)
    u = ln_lanes(F.pad(x, (0, 0, 0, lp - l)), ln_scale, ln_bias, eps)
    uq, us = row_codes(u.reshape(b * lp, c))
    part = qkv_amax_plain(uq, us, wq, ws)
    qkv_q, qkv_s, qkv_d = qkv_code_plain(uq, us, wq, ws, part, l, lp,
                                         x.dtype)
    a = packed_attention_plain(qkv_d.reshape(b, l, 3 * c), num_heads,
                               (c // num_heads) ** -0.5)
    return a, qkv_q.reshape(b, lp, 3 * c), qkv_s.reshape(b, lp, 1)


def _qkv_product(uq, us, wq, ws):
    """Row 18's product ``(f32(acc) * us) * ws`` of the row codes uq [M, C]
    with scales us [M, 1]: [M, 3C] f32."""
    return int_matmul(uq, wq).float() * us * _vec(ws)


def qkv_amax_plain(uq: torch.Tensor, us: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """Twin of row 18's pass A (``uspace_qkv_amax``): max |p| of each row of
    the product p over each block of QKV_BLOCK columns (the GEMM's tile),
    [M, ceil(3C / QKV_BLOCK)] f32."""
    p = _qkv_product(uq, us, wq, ws).abs()
    p = F.pad(p, (0, -p.shape[-1] % QKV_BLOCK))
    return p.reshape(p.shape[0], -1, QKV_BLOCK).amax(dim=-1)


def qkv_code_plain(uq: torch.Tensor, us: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor, part: torch.Tensor, l: int, lp: int,
                   dtype: torch.dtype = torch.bfloat16):
    """Twin of row 18's pass B (``uspace_qkv_code``): the product p coded
    per row with ``amax = max(max of the row's partials, 1e-8)``,
    ``round(p * (127 / amax))`` and the scale ``amax * (1/127)`` (the rule
    of :func:`ops.quant.row_codes`); ``(qkv_q [M, 3C] int8, qkv_s [M, 1]
    f32, qkv [rows, 3C])``, qkv ``f32(qkv_q) * qkv_s`` rounded to ``dtype``
    of the rows m = b Lp + i with i < L, in order."""
    amax = torch.clamp(part.amax(dim=-1, keepdim=True), min=1e-8)
    qkv_q = torch.round(_qkv_product(uq, us, wq, ws)
                        * true_div(QMAX, amax)).to(torch.int8)
    qkv_s = amax * (1.0 / QMAX)
    keep = torch.arange(uq.shape[0], device=uq.device) % lp < l
    return qkv_q, qkv_s, (qkv_q[keep].float() * qkv_s[keep]).to(dtype)


def delta_attn_plain(x: torch.Tensor, xb: torch.Tensor, qkv_q: torch.Tensor,
                     qkv_s: torch.Tensor, a_b: torch.Tensor,
                     xm_b: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, wq: torch.Tensor,
                     ws: torch.Tensor, wp: torch.Tensor, sp: torch.Tensor,
                     num_heads: int, eps: float) -> torch.Tensor:
    """Twin of ``_delta_attn_kernel`` on the L real rows, as the card runs
    it: the codes of ``LN1(x) - LN1(x_b)`` (:func:`ln_delta_codes_plain`),
    ``qkv = bf16(f32(qkv_q) * qkv_s + (f32(acc) * ds) * ws)``
    (:func:`qkv_delta_plain`, in x's dtype), the attention core, ``da =
    f32(a) - f32(a_b)`` coded per row, ``xm = bf16(((x - x_b) + xm_b) +
    (f32(acc) * das) * sp)`` in f32 (:func:`xm_delta_plain`)."""
    b, l, c = x.shape
    codes, ds = ln_delta_codes_plain(x, xb, ln_scale, ln_bias, eps)
    qkv = qkv_delta_plain(codes.reshape(-1, c), ds.reshape(-1, 1), wq, ws,
                          qkv_q, qkv_s, l, x.dtype)
    a = packed_attention_plain(qkv.reshape(b, l, 3 * c), num_heads,
                               (c // num_heads) ** -0.5)
    daq, das = row_codes(a.float() - a_b[:, :l].float())
    return xm_delta_plain(daq, das, wp, sp, x, xb, xm_b)


def ln_delta_codes_plain(x: torch.Tensor, xb: torch.Tensor,
                         ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         eps: float):
    """Twin of the code pass of a stage delta (``uspace_ln_delta_codes``,
    rows 19 and 23-25): the row codes of ``LN(x) - LN(x_b)``, ``(codes,
    scales [..., 1])``."""
    return row_codes(ln_lanes(x, ln_scale, ln_bias, eps)
                     - ln_lanes(xb, ln_scale, ln_bias, eps))


def _cache_rows(m: int, l: int, lp: int, device) -> torch.Tensor:
    """The padded cache's row of each of the rows r = b L + l of a stage."""
    r = torch.arange(m, device=device)
    return r // l * lp + r % l


def qkv_delta_plain(codes: torch.Tensor, sr: torch.Tensor, wq: torch.Tensor,
                    ws: torch.Tensor, qkv_q: torch.Tensor,
                    qkv_s: torch.Tensor, l: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Twin of row 19's qkv GEMM (``uspace_qkv_delta``) on codes [M, C]
    with scales ``sr [M, 1]`` of the rows r = b L + l: ``f32(cq) * cs +
    (f32(acc) * sr) * ws`` rounded to ``dtype`` (the kernel's bf16, x's
    dtype in :func:`delta_attn_plain`), the cache ``qkv_q [B, Lp, 3C]``,
    ``qkv_s [B, Lp, 1]`` read at the cache row of r; returns [M, 3C]."""
    n = qkv_q.shape[-1]
    at = _cache_rows(codes.shape[0], l, qkv_q.shape[1], codes.device)
    cq, cs = qkv_q.reshape(-1, n)[at], qkv_s.reshape(-1, 1)[at]
    dqkv = int_matmul(codes, wq).float() * sr * _vec(ws)
    return (cq.float() * cs + dqkv).to(dtype)


def xm_delta_plain(codes: torch.Tensor, sr: torch.Tensor, wp: torch.Tensor,
                   sp: torch.Tensor, x: torch.Tensor, xb: torch.Tensor,
                   xm_b: torch.Tensor) -> torch.Tensor:
    """Twin of row 19's xm GEMM (``uspace_xm_delta``) on the codes [M, C]
    and scales ``sr [M, 1]`` of ``a - a_b``: ``bf16(((f32(x) - f32(x_b)) +
    f32(xm_b)) + (f32(acc) * sr) * sp)`` for x, x_b, xm_b [M, C]."""
    dp = int_matmul(codes, wp).float() * sr * _vec(sp)
    return (x.float() - xb.float() + xm_b.float() + dp).to(x.dtype)


# Rows 21 and 22 as the card runs them, each piece one launch: the code
# pass, the row's fc1, fc2 with m; the whole twins are the pieces in sequence.


def _grad_hidden(e):
    """Row 22's hidden of the exact f32 e: ``GELU(e)``, and gelu'(e) coded
    per row as the cache."""
    return _gelu_f32(e), row_codes(gelu_grad(e))


def _eg_hidden(e):
    """Rows 20-21's hidden: ``GELU(f32(e_q) * e_s)`` of e coded per row,
    ``(e_q, e_s)`` the cache."""
    e_q, e_s = row_codes(e)
    return _gelu_f32(e_q.float() * e_s), (e_q, e_s)


def base_codes_plain(x2d: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, eps: float):
    """Twin of rows 21-22's code pass (``uspace_base_mlp_codes``): the row
    codes of the f32 LN2 rows in lane order, ``(codes [R, C] int8, scales
    [R, 1] f32)``."""
    return row_codes(ln_lanes(x2d, ln_scale, ln_bias, eps))


def _base_fc1(xq, xs, w1q, s1, b1, strips, hidden_of):
    """fc1 of the base rows on the row codes ``xq [R, C]`` with scales ``xs
    [R, 1]``: per strip ``e = f32(acc) * xs * s1 + b1``, ``g, cache =
    hidden_of(e)`` and g on its affine grid; returns the strips' ``(*cache,
    codes, scales, zero points)``, each [R, hidden] or [R, strips]."""
    hs = w1q.shape[-1] // strips
    s1f, b1f = _vec(s1), _vec(b1)
    parts = []
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        e = int_matmul(xq, w1q[:, cols]).float() * xs * s1f[cols] + b1f[cols]
        g, cache = hidden_of(e)
        parts.append((*cache, *affine_codes(g)))
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def base_fc1_grad_plain(xq: torch.Tensor, xs: torch.Tensor,
                        w1q: torch.Tensor, s1: torch.Tensor,
                        b1: torch.Tensor, strips: int):
    """Twin of row 22's fc1 (``uspace_base_fc1_grad``): ``(gp_q, gp_s, hq,
    hsc, hzp)``, gelu'(e) coded per row and strip and GELU(e) on its affine
    grid, from the row codes ``xq [R, C]`` and scales ``xs [R, 1]``; ``w1q``
    int8 [C, hidden] (JAX layout)."""
    return _base_fc1(xq, xs, w1q, s1, b1, strips, _grad_hidden)


def base_fc1_eg_plain(xq: torch.Tensor, xs: torch.Tensor, w1q: torch.Tensor,
                      s1: torch.Tensor, b1: torch.Tensor, strips: int):
    """Twin of row 21's fc1 (``uspace_base_fc1_eg``): ``(e_q, e_s, g_q,
    g_s, g_z)``, e coded per row and strip and ``GELU(f32(e_q) * e_s)`` on
    its affine grid (the codes fc2 reads), from the row codes ``xq [R, C]``
    and scales ``xs [R, 1]``."""
    return _base_fc1(xq, xs, w1q, s1, b1, strips, _eg_hidden)


def base_fc2_plain(hq: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                   w2q: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
                   x2d: torch.Tensor):
    """Twin of rows 21-22's fc2 (``uspace_base_fc2``): the strips'
    ``f32(d_j) * scale_j + zp_j * colsum_j`` folded in order, ``m = bf16(acc
    * s2 + b2)`` in x's dtype; ``(x + m, m)``. ``w2q`` int8 [hidden, C] (JAX
    layout)."""
    strips = scale.shape[1]
    hs = hq.shape[1] // strips
    colsum = strip_colsums(w2q, strips)
    acc = None
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        t = (int_matmul(hq[:, cols], w2q[cols]).float() * scale[:, j:j + 1]
             + zp[:, j:j + 1] * colsum[j])
        acc = t if acc is None else acc + t
    m = (acc * _vec(s2) + _vec(b2)).to(x2d.dtype)
    return x2d + m, m


def _base_mlp_twin(x2d, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps,
                   strips, hidden_of):
    """The base MLP halves on rows x [R, C] as the code pass, fc1 of
    ``hidden_of`` and fc2: ``(o, m, *cache, codes, scales, zero points)``."""
    xq, xs = base_codes_plain(x2d, ln_scale, ln_bias, eps)
    *cache, hq, hsc, hzp = _base_fc1(xq, xs, w1q, s1, b1, strips, hidden_of)
    return (*base_fc2_plain(hq, hsc, hzp, w2q, s2, b2, x2d), *cache, hq, hsc,
            hzp)


def base_mlp_grad_plain(x2d: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, w1q: torch.Tensor,
                        s1: torch.Tensor, b1: torch.Tensor,
                        w2q: torch.Tensor, s2: torch.Tensor,
                        b2: torch.Tensor, eps: float, strips: int):
    """Twin of ``_base_mlp_cache_kernel_gr`` on rows x [R, C]: ``(o, gp_q,
    gp_s, m)``. Per strip the exact f32 ``e``: gelu'(e) coded per row
    (``gp_s[:, j]``), GELU(e) the hidden."""
    o, m, gp_q, gp_s, *_ = _base_mlp_twin(
        x2d, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps, strips,
        _grad_hidden)
    return o, gp_q, gp_s, m


def base_mlp_e_plain(x2d: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, w1q: torch.Tensor,
                     s1: torch.Tensor, b1: torch.Tensor, w2q: torch.Tensor,
                     s2: torch.Tensor, b2: torch.Tensor, eps: float,
                     strips: int, emit_gelu: bool = False):
    """Twin of ``_base_mlp_cache_kernel`` (``emit_gelu``:
    ``_base_mlp_cache_kernel_g``) on rows x [R, C]: ``(o, e_q, e_s, m)``,
    with ``emit_gelu`` also ``(g_q, g_s, g_z)``. Per strip ``e`` coded per
    row (``e_s[:, j]``), the hidden ``GELU(f32(e_q) * e_s)``; ``g_q``, ``g_s``
    and ``g_z`` are the affine codes, scales and zero points fc2 read."""
    o, m, e_q, e_s, g_q, g_s, g_z = _base_mlp_twin(
        x2d, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps, strips,
        _eg_hidden)
    return (o, e_q, e_s, m) + ((g_q, g_s, g_z) if emit_gelu else ())


def _delta_mlp_twin(x2d, xb2d, m_b, ln_scale, ln_bias, w1q, s1, w2q, s2, eps,
                    strips, dg_of):
    """The delta MLP halves on rows [R, C]: the codes of ``LN2(x) -
    LN2(x_b)``; per strip ``de = f32(acc) * ds * s1``, ``dg = dg_of(j, cols,
    de)`` coded per row, ``acc += f32(d_j) * scale_j``; ``o = x + bf16(f32(
    m_b) + acc * s2)``."""
    hs = w1q.shape[-1] // strips
    d = ln_lanes(x2d, ln_scale, ln_bias, eps) - ln_lanes(xb2d, ln_scale,
                                                         ln_bias, eps)
    dq, ds = row_codes(d)
    s1f = _vec(s1)
    acc = None
    for j in range(strips):
        cols = slice(j * hs, (j + 1) * hs)
        de = int_matmul(dq, w1q[:, cols]).float() * ds * s1f[cols]
        hq, hsc = row_codes(dg_of(j, cols, de))
        t = int_matmul(hq, w2q[cols]).float() * hsc
        acc = t if acc is None else acc + t
    m = m_b.float() + acc * _vec(s2)
    return x2d + m.to(x2d.dtype)


def delta_mlp_lin_plain(x2d: torch.Tensor, xb2d: torch.Tensor,
                        gp_q: torch.Tensor, gp_s: torch.Tensor,
                        m_b: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, w1q: torch.Tensor,
                        s1: torch.Tensor, w2q: torch.Tensor,
                        s2: torch.Tensor, eps: float,
                        strips: int) -> torch.Tensor:
    """Twin of ``_delta_mlp_kernel_lin`` on rows [R, C]: ``dg = de *
    (f32(gp_q) * gp_s[:, j])``."""
    return _delta_mlp_twin(
        x2d, xb2d, m_b, ln_scale, ln_bias, w1q, s1, w2q, s2, eps, strips,
        lambda j, cols, de: de * (gp_q[:, cols].float() * gp_s[:, j:j + 1]))


def delta_mlp_exact_plain(x2d: torch.Tensor, xb2d: torch.Tensor,
                          e_q: torch.Tensor, e_s: torch.Tensor,
                          m_b: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, w1q: torch.Tensor,
                          s1: torch.Tensor, w2q: torch.Tensor,
                          s2: torch.Tensor, eps: float,
                          strips: int) -> torch.Tensor:
    """Twin of ``_delta_mlp_kernel`` on rows [R, C]: ``dg = gelu(e_b + de) -
    gelu(e_b)`` with ``e_b = f32(e_q) * e_s[:, j]``: two GELUs per value."""
    def dg_of(j, cols, de):
        e_b = e_q[:, cols].float() * e_s[:, j:j + 1]
        return _gelu_f32(e_b + de) - _gelu_f32(e_b)

    return _delta_mlp_twin(x2d, xb2d, m_b, ln_scale, ln_bias, w1q, s1, w2q,
                           s2, eps, strips, dg_of)


def delta_mlp_g_plain(x2d: torch.Tensor, xb2d: torch.Tensor,
                      e_q: torch.Tensor, e_s: torch.Tensor,
                      g_q: torch.Tensor, g_s: torch.Tensor, g_z: torch.Tensor,
                      m_b: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w1q: torch.Tensor,
                      s1: torch.Tensor, w2q: torch.Tensor, s2: torch.Tensor,
                      eps: float, strips: int) -> torch.Tensor:
    """Twin of ``_delta_mlp_kernel_g`` on rows [R, C]: ``dg = gelu(e_b + de)
    - g_b`` with ``g_b = f32(g_q) * g_s[:, j] + g_z[:, j]`` (the affine
    hidden fc2 read in the base, two roundings): one GELU per value."""
    def dg_of(j, cols, de):
        e_b = e_q[:, cols].float() * e_s[:, j:j + 1]
        g_b = g_q[:, cols].float() * g_s[:, j:j + 1] + g_z[:, j:j + 1]
        return _gelu_f32(e_b + de) - g_b

    return _delta_mlp_twin(x2d, xb2d, m_b, ln_scale, ln_bias, w1q, s1, w2q,
                           s2, eps, strips, dg_of)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _codes_nk(name: str, w: torch.Tensor, n: int, k: int,
              dev: torch.device) -> torch.Tensor:
    """The kernels' ``[N, K]`` rows of codes given in the JAX layout ``[K,
    N]`` (free for the ``kn`` view of a QWeight)."""
    t = w.t().contiguous()
    check_tensor(f"{name} codes", t, torch.int8, (n, k), dev)
    return t


def _attn_operands(x, num_heads, c, ln_scale, ln_bias, ws, dev):
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"the stage-delta attention kernels take x [B, L, C] "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    if (c % num_heads or c // num_heads not in KERNEL_HEAD_DIMS
            or c % 128):
        raise ValueError(f"the stage-delta attention kernels take head dim "
                         f"{' or '.join(map(str, KERNEL_HEAD_DIMS))} and C a "
                         f"multiple of 128, got "
                         f"C={c} with {num_heads} heads")
    if not 1 <= x.shape[1] <= KERNEL_MAX_LEN:
        raise ValueError(f"the stage-delta attention kernels take 1 <= L <= "
                         f"{KERNEL_MAX_LEN}, got {x.shape[1]}")
    check_tensor("x", x, torch.bfloat16, tuple(x.shape), dev)
    lns, lnb, wsf = _vec(ln_scale), _vec(ln_bias), _vec(ws)
    check_tensor("ln_scale", lns, torch.float32, (c,), dev)
    check_tensor("ln_bias", lnb, torch.float32, (c,), dev)
    check_tensor("ws", wsf, torch.float32, (3 * c,), dev)
    return lns, lnb, wsf


def base_attn_ws_sizes(b: int, l: int, lp: int, c: int):
    """Byte sizes of the pieces of row 18's workspace, in order, each
    rounded up to 256 bytes in it: the LN1 row codes [B Lp, C] int8 and
    scales [B Lp] f32, pass A's amax partials [B Lp, ceil(3C / QKV_BLOCK)]
    f32, the core's bf16 input [B, L, 3C]."""
    m, n = b * lp, 3 * c
    return [m * c, 4 * m, 4 * m * -(-n // QKV_BLOCK), 2 * b * l * n]


def _ws_pieces(ws: torch.Tensor, sizes):
    """The addresses of the workspace's pieces of the given sizes."""
    at, out = ws.data_ptr(), []
    for n in sizes:
        out.append(at)
        at += -(-n // 256) * 256
    return out


def _base_attn_kernel(x, ln_scale, ln_bias, wq, ws, num_heads, eps):
    """Two C calls through one workspace allocation: the padded LN1 code
    pass, then pass A, pass B and row 1's core from one entry; counted as
    one launch."""
    b, l, c = x.shape
    dev = x.device
    lp = round_up(l, SEQ_ALIGN)
    lns, lnb, wsf = _attn_operands(x, num_heads, c, ln_scale, ln_bias, ws,
                                   dev)
    w = _codes_nk("wq", wq, 3 * c, c, dev)
    stream = cuda_stream(dev)
    qkv_q = torch.empty((b, lp, 3 * c), dtype=torch.int8, device=dev)
    qkv_s = torch.empty((b, lp, 1), dtype=torch.float32, device=dev)
    a = torch.empty_like(x)
    sizes = base_attn_ws_sizes(b, l, lp, c)
    work = _base_workspace(dev, sizes)
    uq, us, part, qkv_d = _ws_pieces(work, sizes)
    raise_on(load("delta_attention").uspace_ln_codes(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), uq, us, b, l, lp, c,
        eps, stream), "uspace_ln_codes")
    raise_on(load("attention").uspace_base_attn(
        uq, us, w.data_ptr(), wsf.data_ptr(), part, qkv_q.data_ptr(),
        qkv_s.data_ptr(), qkv_d, a.data_ptr(), b, l, lp, num_heads,
        c // num_heads, (c // num_heads) ** -0.5, stream), "uspace_base_attn")
    del work  # held until the launches are queued
    LAUNCHES["base_attn_cache"] += 1
    return a, qkv_q, qkv_s


def _padded_codes_kernel(x, lns, lnb, eps):
    """Row 18's code pass alone (``uspace_ln_codes``): the row codes of LN1
    of x [B, L, C] bf16 padded with zero rows to Lp, ``(codes [B Lp, C]
    int8, sr [B Lp] f32)``. Counted by no op."""
    b, l, c = x.shape
    lp = round_up(l, SEQ_ALIGN)
    codes = torch.empty((b * lp, c), dtype=torch.int8, device=x.device)
    sr = torch.empty((b * lp,), dtype=torch.float32, device=x.device)
    raise_on(load("delta_attention").uspace_ln_codes(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), codes.data_ptr(),
        sr.data_ptr(), b, l, lp, c, eps, cuda_stream(x.device)),
        "uspace_ln_codes")
    return codes, sr


def _qkv_amax_kernel(codes, sr, w, wsf):
    """Row 18's pass A alone: :func:`qkv_amax_plain` on the card for codes
    [M, C] int8 with sr [M] f32 and w [3C, C] int8 (torch layout) with its
    f32 scales. Counted by no op."""
    m = codes.shape[0]
    n = w.shape[0]
    part = torch.empty((m, -(-n // QKV_BLOCK)), dtype=torch.float32,
                       device=codes.device)
    raise_on(load("attention").uspace_qkv_amax(
        codes.data_ptr(), sr.data_ptr(), w.data_ptr(), wsf.data_ptr(),
        part.data_ptr(), m, n, codes.shape[1], cuda_stream(codes.device)),
        "uspace_qkv_amax")
    return part


def _qkv_code_kernel(codes, sr, w, wsf, part, l, lp):
    """Row 18's pass B alone: :func:`qkv_code_plain` on the card (the rows
    m of [., Lp], those with m % Lp < L into the bf16 output): ``(qkv_q [M,
    3C] int8, qkv_s [M] f32, qkv [rows, 3C] bf16)``. Counted by no op."""
    m, c = codes.shape
    n, dev = w.shape[0], codes.device
    rows = m // lp * l + min(m % lp, l)
    qkv_q = torch.empty((m, n), dtype=torch.int8, device=dev)
    qkv_s = torch.empty((m,), dtype=torch.float32, device=dev)
    qkv = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)
    raise_on(load("attention").uspace_qkv_code(
        codes.data_ptr(), sr.data_ptr(), w.data_ptr(), wsf.data_ptr(),
        part.data_ptr(), qkv_q.data_ptr(), qkv_s.data_ptr(), qkv.data_ptr(),
        m, l, lp, n, c, cuda_stream(dev)), "uspace_qkv_code")
    return qkv_q, qkv_s, qkv


def _delta_attn_kernel(x, xb, qkv_q, qkv_s, a_b, xm_b, ln_scale, ln_bias,
                       wq, ws, wp, sp, num_heads, eps):
    b, l, c = x.shape
    dev, r = x.device, b * l
    lp = round_up(l, SEQ_ALIGN)
    lns, lnb, wsf = _attn_operands(x, num_heads, c, ln_scale, ln_bias, ws,
                                   dev)
    spf = _vec(sp)
    check_tensor("sp", spf, torch.float32, (c,), dev)
    for name, t in (("x_b", xb), ("a_b", a_b), ("xm_b", xm_b)):
        # a_b is read on its L real rows only (the JAX kernel's block of Lp
        # rows runs past the end of the unpadded cache)
        check_tensor(name, t, torch.bfloat16, (b, l, c), dev)
    check_tensor("qkv_q", qkv_q, torch.int8, (b, lp, 3 * c), dev)
    check_tensor("qkv_s", qkv_s, torch.float32, (b, lp, 1), dev)
    w = _codes_nk("wq", wq, 3 * c, c, dev)
    wpr = _codes_nk("wp", wp, c, c, dev)
    stream = cuda_stream(dev)
    a = torch.empty_like(x)
    codes, sr = _ln_delta_codes_kernel(x, xb, lns, lnb, eps, stream)
    qkv = _qkv_delta_kernel(codes, sr, w, wsf, qkv_q, qkv_s, l, stream)
    raise_on(load("attention").uspace_packed_attention(
        qkv.data_ptr(), a.data_ptr(), b, l, num_heads, c // num_heads,
        (c // num_heads) ** -0.5, stream), "uspace_packed_attention")
    raise_on(load("delta_attention").uspace_diff_codes(
        a.data_ptr(), a_b.data_ptr(), codes.data_ptr(), sr.data_ptr(), r, c,
        stream), "uspace_diff_codes")
    xm = _xm_delta_kernel(codes, sr, wpr, spf, x, xb, xm_b, stream)
    LAUNCHES["delta_attn"] += 1
    return xm


def _ln_delta_codes_kernel(x, xb, ln_scale, ln_bias, eps, stream=None):
    """The code pass of a stage delta (``uspace_ln_delta_codes``, rows 19 and
    23-25) on x, x_b [..., C] bf16: ``(codes [R, C] int8, sr [R] f32)``.
    Counted by no op."""
    c = x.shape[-1]
    r = x.numel() // c
    dev = x.device
    lns, lnb = _vec(ln_scale), _vec(ln_bias)
    codes = torch.empty((r, c), dtype=torch.int8, device=dev)
    sr = torch.empty((r,), dtype=torch.float32, device=dev)
    raise_on(load("delta_attention").uspace_ln_delta_codes(
        x.data_ptr(), xb.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        codes.data_ptr(), sr.data_ptr(), r, c, eps,
        cuda_stream(dev) if stream is None else stream),
        "uspace_ln_delta_codes")
    return codes, sr


def _qkv_delta_kernel(codes, sr, w, wsf, qkv_q, qkv_s, l, stream=None):
    """Row 19's qkv GEMM alone: :func:`qkv_delta_plain` on the card for
    codes [M, C] int8 with sr [M] f32, w [3C, C] int8 (torch layout) with
    its f32 scales, the padded cache [B, Lp, 3C] (B * L >= M); returns [M,
    3C] bf16. Counted by no op."""
    m, c = codes.shape
    n, lp = w.shape[0], qkv_q.shape[1]
    if -(-m // l) > qkv_q.shape[0]:
        raise ValueError(f"{m} rows of L={l} need a cache of "
                         f"{-(-m // l)} batch elements, got {qkv_q.shape[0]}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=codes.device)
    raise_on(load("attention").uspace_qkv_delta(
        codes.data_ptr(), sr.data_ptr(), w.data_ptr(), wsf.data_ptr(),
        qkv_q.data_ptr(), qkv_s.data_ptr(), out.data_ptr(), m, l, lp, n, c,
        cuda_stream(codes.device) if stream is None else stream),
        "uspace_qkv_delta")
    return out


def _xm_delta_kernel(codes, sr, wp, spf, x, xb, xm_b, stream=None):
    """Row 19's xm GEMM alone: :func:`xm_delta_plain` on the card for codes
    [M, C] int8 with sr [M] f32, wp [C, C] int8 (torch layout) with its f32
    scales, x, x_b, xm_b of M rows of C bf16; returns x's shape. Counted by
    no op."""
    m, c = codes.shape
    out = torch.empty_like(x)
    raise_on(load("attention").uspace_xm_delta(
        codes.data_ptr(), sr.data_ptr(), wp.data_ptr(), spf.data_ptr(),
        x.data_ptr(), xb.data_ptr(), xm_b.data_ptr(), out.data_ptr(), m,
        wp.shape[0], c,
        cuda_stream(codes.device) if stream is None else stream),
        "uspace_xm_delta")
    return out


def _mlp_operands(x2d, w1q, s1, w2q, s2, strips, ln_scale, ln_bias):
    r, c = x2d.shape
    hidden = w1q.shape[-1]
    dev = x2d.device
    hs = hidden // strips
    if x2d.dtype != torch.bfloat16:
        raise ValueError(f"the stage-delta MLP kernels take bfloat16, got "
                         f"{x2d.dtype}")
    if c % 256 or c > 2048 or hs % 256 or hs > 1024 or c > hs:
        raise ValueError(
            f"the stage-delta MLP kernels take C a multiple of 256 up to "
            f"2048 and a strip width hidden/{strips} of 256, 512, 768 or "
            f"1024 and >= C; got C={c}, hidden={hidden}")
    check_tensor("x", x2d, torch.bfloat16, (r, c), dev)
    w1 = _codes_nk("w1", w1q, hidden, c, dev)
    w2 = _codes_nk("w2", w2q, c, hidden, dev)
    out = [_vec(t) for t in (ln_scale, ln_bias, s1, s2)]
    for name, t, n in zip(("ln_scale", "ln_bias", "s1", "s2"), out,
                          (c, c, hidden, c)):
        check_tensor(name, t, torch.float32, (n,), dev)
    return (w1, w2, *out)


def base_ws_sizes(r: int, c: int, hidden: int, strips: int, mode: str):
    """Byte sizes of the pieces of rows 20-22's workspace, in the order in
    which their C entries carve it, each rounded up to 256 bytes there: the
    row codes [R, C] int8 and scales [R] f32, and for ``"grad"`` and
    ``"e"`` the hidden codes [R, hidden] int8 with their scales and zero
    points [R, strips] f32 (row 20's g_q, g_s, g_z; row 21 writes them to
    its caller)."""
    sizes = [r * c, 4 * r]
    if mode != "e+g":
        sizes += [r * hidden, 4 * r * strips, 4 * r * strips]
    return sizes


def _base_workspace(dev, sizes) -> torch.Tensor:
    """One byte tensor for a workspace of pieces of the given sizes."""
    return torch.empty(sum(-(-n // 256) * 256 for n in sizes),
                       dtype=torch.uint8, device=dev)


def _base_mlp_kernel(x2d, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps,
                     strips, mode):
    """One C call: rows 20, 21 and 22 (``"e"``, ``"e+g"``, ``"grad"``)
    launch the code pass, fc1 and fc2 with m, counted as one, through one
    workspace allocation."""
    r, c = x2d.shape
    hidden = w1q.shape[-1]
    dev = x2d.device
    w1, w2, lns, lnb, s1f, s2f = _mlp_operands(x2d, w1q, s1, w2q, s2, strips,
                                               ln_scale, ln_bias)
    b1f, b2f = _vec(b1), _vec(b2)
    check_tensor("b1", b1f, torch.float32, (hidden,), dev)
    check_tensor("b2", b2f, torch.float32, (c,), dev)
    colsum = strip_colsums(w2q, strips)
    check_tensor("colsums", colsum, torch.float32, (strips, c), dev)
    o, m = torch.empty_like(x2d), torch.empty_like(x2d)

    def codes():
        return (torch.empty((r, hidden), dtype=torch.int8, device=dev),
                torch.empty((r, strips), dtype=torch.float32, device=dev))
    # the cache: (gp_q, gp_s) or (e_q, e_s), and for "e+g" (g_q, g_s, g_z)
    cache = codes()
    if mode == "e+g":
        cache += codes() + (torch.empty_like(cache[1]),)
    ws = _base_workspace(dev, base_ws_sizes(r, c, hidden, strips, mode))
    _base_mlp_entry(mode, x2d, lns, lnb, w1, s1f, b1f, w2, s2f, b2f, colsum,
                    o, m, cache + (ws,), strips, eps)
    del ws  # held until the launches are queued
    LAUNCHES[BASE_MODES[mode]] += 1
    return (o, cache[0], cache[1], m) + cache[2:]


def _base_mlp_entry(mode, x2d, lns, lnb, w1, s1f, b1f, w2, s2f, b2f, colsum,
                    o, m, rest, strips, eps):
    """The one C call of rows 20-22 on checked operands, into o, m and
    ``rest`` (the mode's cache, then the workspace)."""
    r, c = x2d.shape
    fn = "uspace_" + BASE_MODES[mode]
    raise_on(getattr(load("delta_mlp"), fn)(
        x2d.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
        s1f.data_ptr(), b1f.data_ptr(), w2.data_ptr(), s2f.data_ptr(),
        b2f.data_ptr(), colsum.data_ptr(), o.data_ptr(), m.data_ptr(),
        *(t.data_ptr() for t in rest), r, c, w1.shape[0], strips, eps,
        cuda_stream(x2d.device)), fn)


# Rows 21-22's pieces alone, each counted by no op, for their tests and
# timings; the wrapper above checks their operands (f32 contiguous scales
# and biases, bf16 rows, w1 [hidden, C] and w2 [C, hidden] int8 in the
# torch layout).


def _base_codes_kernel(x2d, lns, lnb, eps, out=None):
    """The f32 code pass (``uspace_base_mlp_codes``) of x [R, C] bf16:
    ``(codes [R, C] int8, sr [R] f32)`` as :func:`base_codes_plain`, into
    ``out`` where given."""
    r, c = x2d.shape
    dev = x2d.device
    codes, sr = out or (torch.empty((r, c), dtype=torch.int8, device=dev),
                        torch.empty((r,), dtype=torch.float32, device=dev))
    raise_on(load("delta_mlp").uspace_base_mlp_codes(
        x2d.data_ptr(), lns.data_ptr(), lnb.data_ptr(), codes.data_ptr(),
        sr.data_ptr(), r, c, eps, cuda_stream(dev)), "uspace_base_mlp_codes")
    return codes, sr


def _base_fc1_kernel(codes, sr, w1, s1f, b1f, strips, mode, out=None,
                     lib=None):
    """fc1 of row 22 (``mode="grad"``, ``uspace_base_fc1_grad``: ``(gp_q,
    gp_s, hq, hsc, hzp)``) or row 21 (``"e+g"``, ``uspace_base_fc1_eg``:
    ``(e_q, e_s, g_q, g_s, g_z)``) as their twins, into ``out`` where
    given; ``lib`` another build of the library."""
    r, c = codes.shape
    hidden = w1.shape[0]
    dev = codes.device
    if out is None:
        out = []
        for _ in range(2):
            out += [torch.empty((r, hidden), dtype=torch.int8, device=dev),
                    torch.empty((r, strips), dtype=torch.float32, device=dev)]
        out.append(torch.empty_like(out[1]))
    fn = "uspace_base_fc1_" + ("grad" if mode == "grad" else "eg")
    raise_on(getattr(lib or load("delta_mlp"), fn)(
        codes.data_ptr(), sr.data_ptr(), w1.data_ptr(), s1f.data_ptr(),
        b1f.data_ptr(), *(t.data_ptr() for t in out), r, c, hidden, strips,
        cuda_stream(dev)), fn)
    return tuple(out)


def _base_fc2_kernel(hq, hsc, hzp, w2, s2f, b2f, colsum, x2d, out=None):
    """fc2 with m (``uspace_base_fc2``): ``(x + m, m)`` as
    :func:`base_fc2_plain`, into ``out`` where given."""
    r, hidden = hq.shape
    o, m = out or (torch.empty_like(x2d), torch.empty_like(x2d))
    raise_on(load("delta_mlp").uspace_base_fc2(
        hq.data_ptr(), hsc.data_ptr(), hzp.data_ptr(), w2.data_ptr(),
        s2f.data_ptr(), b2f.data_ptr(), colsum.data_ptr(), x2d.data_ptr(),
        o.data_ptr(), m.data_ptr(), r, w2.shape[0], hidden, hsc.shape[1],
        cuda_stream(x2d.device)), "uspace_base_fc2")
    return o, m


def _delta_mlp_kernel(x2d, xb2d, c_q, c_s, gelu_cache, mb2d, ln_scale,
                      ln_bias, w1q, s1, w2q, s2, eps, strips, grad):
    r, c = x2d.shape
    hidden = w1q.shape[-1]
    dev = x2d.device
    w1, w2, lns, lnb, s1f, s2f = _mlp_operands(x2d, w1q, s1, w2q, s2, strips,
                                               ln_scale, ln_bias)
    check_tensor("x_b", xb2d, torch.bfloat16, (r, c), dev)
    check_tensor("m_b", mb2d, torch.bfloat16, (r, c), dev)
    what = "gp" if grad else "e"
    check_tensor(f"{what}_q", c_q, torch.int8, (r, hidden), dev)
    check_tensor(f"{what}_s", c_s, torch.float32, (r, strips), dev)
    cache = (c_q, c_s)
    if gelu_cache is not None:
        g_q, g_s, g_z = gelu_cache
        check_tensor("g_q", g_q, torch.int8, (r, hidden), dev)
        check_tensor("g_s", g_s, torch.float32, (r, strips), dev)
        check_tensor("g_z", g_z, torch.float32, (r, strips), dev)
        cache += (g_q, g_s, g_z)
    # three launches: row 19's code pass, the mode's fc1, fc2; the mode
    # names both the fc1 entry and the launch count
    mode = "lin" if grad else "exact" if gelu_cache is None else "g"
    fc1 = f"uspace_delta_fc1_{mode}"
    o = torch.empty_like(x2d)
    stream = cuda_stream(dev)
    codes, sr = _ln_delta_codes_kernel(x2d, xb2d, lns, lnb, eps, stream)
    hq = torch.empty((r, hidden), dtype=torch.int8, device=dev)
    hsc = torch.empty((r, strips), dtype=torch.float32, device=dev)
    lib = load("delta_mlp")
    raise_on(getattr(lib, fc1)(
        codes.data_ptr(), sr.data_ptr(), w1.data_ptr(), s1f.data_ptr(),
        *(t.data_ptr() for t in cache), hq.data_ptr(), hsc.data_ptr(), r, c,
        hidden, strips, stream), fc1)
    raise_on(lib.uspace_delta_fc2(
        hq.data_ptr(), hsc.data_ptr(), w2.data_ptr(), s2f.data_ptr(),
        mb2d.data_ptr(), x2d.data_ptr(), o.data_ptr(), r, c, hidden, strips,
        stream), "uspace_delta_fc2")
    LAUNCHES[f"delta_mlp_{mode}"] += 1
    return o


# ---------------------------------------------------------------------------
# Public entry points (the JAX package's signatures)
# ---------------------------------------------------------------------------


def base_attn_block(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                    num_heads: int, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(a, qkv_q, qkv_s)``: the attention output [B, L, C] and the padded
    int8 qkv cache ([B, Lp, 3C] int8, [B, Lp, 1] f32). ``wq`` int8 [C, 3C]
    and ``ws`` its f32 column scales."""
    check_no_grad(x, what="the stage-delta attention kernel")
    if on_cpu(x):
        return base_attn_plain(x, ln_scale, ln_bias, wq, ws, num_heads, eps)
    return _base_attn_kernel(x, ln_scale, ln_bias, wq, ws, num_heads, eps)


def delta_attn_block(x: torch.Tensor, xb: torch.Tensor, qkv_q: torch.Tensor,
                     qkv_s: torch.Tensor, a_b: torch.Tensor,
                     xm_b: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, wq: torch.Tensor,
                     ws: torch.Tensor, wp: torch.Tensor, sp: torch.Tensor,
                     num_heads: int, eps: float) -> torch.Tensor:
    """``xm`` [B, L, C]: the whole attention half anchored at the base cache
    (``qkv_q``/``qkv_s`` and ``a_b`` from :func:`base_attn_block`, ``x_b``
    and ``xm_b`` the base's streams). ``wp`` int8 [C, C] and ``sp`` the
    proj's codes and scales."""
    check_no_grad(x, what="the stage-delta attention kernel")
    if on_cpu(x):
        return delta_attn_plain(x, xb, qkv_q, qkv_s, a_b, xm_b, ln_scale,
                                ln_bias, wq, ws, wp, sp, num_heads, eps)
    return _delta_attn_kernel(x, xb, qkv_q, qkv_s, a_b, xm_b, ln_scale,
                              ln_bias, wq, ws, wp, sp, num_heads, eps)


def base_mlp_block(x: torch.Tensor, ln_scale: torch.Tensor,
                   ln_bias: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor,
                   b1: torch.Tensor, w2q: torch.Tensor, s2: torch.Tensor,
                   b2: torch.Tensor, eps: float, mode: str = "e"):
    """The base MLP half of x [..., C] with the hidden cache of ``mode``
    (the JAX function's default ``"e"``): ``(o, e_q, e_s, m)``, the block
    output, the pre-GELU hidden as int8 [rows, hidden] with f32 scales [rows,
    strips], and the bf16 fc2 output; ``"e+g"`` appends ``(g_q, g_s, g_z)``,
    the affine codes fc2 read ([rows, hidden] int8, scales and zero points
    [rows, strips] f32); ``"grad"`` gives ``(o, gp_q, gp_s, m)``, gelu'(e) in
    place of the hidden. ``w1q`` int8 [C, H], ``w2q`` int8 [H, C] with their
    column scales and f32 biases."""
    if mode not in BASE_MODES:
        raise ValueError(f"mode={mode!r} (expected e|e+g|grad)")
    check_no_grad(x, what="the stage-delta MLP kernel")
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    strips = col_slices(w1q.shape[-1])
    args = (ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps, strips)
    if not on_cpu(x):
        out = _base_mlp_kernel(x2d.contiguous(), *args, mode)
    elif mode == "grad":
        out = base_mlp_grad_plain(x2d, *args)
    else:
        out = base_mlp_e_plain(x2d, *args, emit_gelu=mode == "e+g")
    o, q, sc, m = out[:4]
    return (o.reshape(x.shape), q, sc, m.reshape(x.shape)) + tuple(out[4:])


def _check_strip_scales(name: str, t: torch.Tensor, strips: int) -> None:
    """A per-row scale (the unfused base's layout) would be read past its end
    by the per-strip kernel: refuse it."""
    if t.dim() != 2 or t.shape[-1] != strips:
        raise ValueError(f"{name} must hold one scale per row and strip "
                         f"([rows, {strips}], the fused base's layout), got "
                         f"{tuple(t.shape)}")


def delta_mlp_block(x: torch.Tensor, xb: torch.Tensor, e_q: torch.Tensor,
                    e_s: torch.Tensor, m_b: torch.Tensor,
                    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    w1q: torch.Tensor, s1: torch.Tensor, w2q: torch.Tensor,
                    s2: torch.Tensor, eps: float,
                    gelu_cache: Optional[Tuple[torch.Tensor, ...]] = None,
                    grad: bool = False) -> torch.Tensor:
    """``o`` [..., C]: the MLP half anchored at the base cache of
    :func:`base_mlp_block`. By default ``e_q``/``e_s`` are the pre-GELU
    hidden's codes and per-row per-strip scales (``mode="e"``) and the
    two-GELU kernel runs; ``gelu_cache=(g_q, g_s, g_z)`` (``mode="e+g"``)
    runs the one-GELU kernel; with ``grad=True`` ``e_q``/``e_s`` are the
    cached ``gelu'(e_b)`` (``mode="grad"``) and the GELU-free kernel runs."""
    if grad and gelu_cache is not None:
        # the JAX function lets the gelu-cache kernel win and reads the
        # cached slope as the pre-GELU hidden: refuse the contradiction
        raise ValueError("grad=True and gelu_cache contradict each other: "
                         "the 'grad' cache holds gelu'(e), not the pre-GELU "
                         "hidden the gelu-cache kernel reads")
    check_no_grad(x, what="the stage-delta MLP kernel")
    c = x.shape[-1]
    strips = col_slices(w1q.shape[-1])
    _check_strip_scales("gp_s" if grad else "e_s", e_s, strips)
    if gelu_cache is not None:
        _check_strip_scales("g_s", gelu_cache[1], strips)
        _check_strip_scales("g_z", gelu_cache[2], strips)
    x2d, xb2d, mb2d = (t.reshape(-1, c) for t in (x, xb, m_b))
    rest = (ln_scale, ln_bias, w1q, s1, w2q, s2, eps, strips)
    if not on_cpu(x):
        o = _delta_mlp_kernel(x2d.contiguous(), xb2d.contiguous(), e_q, e_s,
                              gelu_cache, mb2d.contiguous(), *rest, grad)
    elif grad:
        o = delta_mlp_lin_plain(x2d, xb2d, e_q, e_s, mb2d, *rest)
    elif gelu_cache is None:
        o = delta_mlp_exact_plain(x2d, xb2d, e_q, e_s, mb2d, *rest)
    else:
        o = delta_mlp_g_plain(x2d, xb2d, e_q, e_s, *gelu_cache, mb2d, *rest)
    return o.reshape(x.shape)
