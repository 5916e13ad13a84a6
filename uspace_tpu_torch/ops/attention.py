"""Multi-head attention for U-ViT denoisers: CUDA kernels + plain path.

Counterpart of ``uspace_tpu/ops/attention.py``. The sampling views launch
kernels hand-written in CUDA C++ for Hopper (``csrc/attention.cu``); they
share one attention core and differ in their prologue:

- :func:`fused_qkv_attention` — packed qkv [B, L, 3C] in device memory
  (TPU kernel ``_packed_fwd_kernel``);
- :func:`fused_qkvproj_attention` — the QKV projection first
  (``_qkv_attn_kernel``; with ``quant=True`` an int8 projection inside the
  kernel, ``_qkv_attn_kernel_q``);
- :func:`fused_ln_qkvproj_attention` — LN1 and the projection first
  (``_qkv_attn_kernel_ln``; int8: ``_qkv_attn_kernel_qln``).

The bf16 projection routes are three launches on one stream, counted as
one call of their op: the LN rows once per row (:func:`ln_rows_plain` is
their twin), the projection of all heads on wgmma into a [B, L, 3C] qkv
workspace (W cast to x's dtype, f32 sums rounded once), and the packed
core on it. The int8 routes keep their projection and core in one kernel.

The bf16 packed and QKV-projection kernels are differentiable, as in the
JAX package: their backward runs :func:`packed_attention_bwd`
(``csrc/attention_bwd.cu``, TPU kernel ``_packed_bwd_kernel``), which
recomputes P from the saved qkv. The LN kernel and both int8 kernels are
inference-only.

The int8 kernels take the f32 weight and quantize it once through
``ops.quant.quantized_weight`` (scales fitted on full precision, as the JAX
package fits them). In the kernel the row's f32 activations (after LN) are
coded as ``round(x * (127 / amax))``, the int32 product is dequantized as
``f32(acc) * (amax * (1/127)) * ws[col]`` and rounded to bf16 qkv; then the
shared attention core runs.

Each wrapper has a plain PyTorch twin in this module with the kernel's
rounding sites (bf16 qkv after the projection, bf16 P before P·V, division
by the f32 row sum after P·V; in the backward bf16 P before Pᵀ·dO and bf16
dS) and a launch count in :data:`LAUNCHES`. A wrapper launches its kernel
for a CUDA tensor and uses the twin only for a tensor on the CPU; on CUDA it
never falls back.

:func:`fused_attention` is the [B, H, L, D] kernel of the SD-UNet's
self-attention (``csrc/attention_fwd.cu``, TPU kernel ``_fwd_kernel``):
K and V stream through shared memory, so it takes any L up to 1024, at
head dims 32 and 64. :func:`multi_head_attention` routes to it as the JAX
dispatcher routes on the TPU (``auto``: 512 < L <= 1024). It is
differentiable as ``_fused_attention`` is: the backward saves only q, k and
v and runs :func:`fused_attention_bwd` (``csrc/fused_attention_bwd.cu``,
TPU kernel ``_bwd_kernel``), which recomputes P and normalises it in f32
before its bf16 cast.

:func:`flash_attention_blocked` is the blocked online-softmax kernel for
long sequences (``csrc/flash_attention.cu``, TPU kernel ``_flash_kernel``):
the running row max, row sum and output are rescaled once per 256-key
block, and P is rounded to bf16 against the running max. The dispatcher
sends every ``pallas`` call with L > 1024 to it, and ``auto`` on the card
too, as the JAX dispatcher routes on the TPU. It has no backward, as the
JAX kernel has none (no ``custom_vjp``): a call that needs a gradient
raises.

The whole pre-norm attention sub-block ``x + proj(attention(qkv(LN1(x))))``
is :func:`fused_attention_block` (``csrc/attention_block.cu``, TPU kernel
``_attn_block_kernel``) and, in W8A8, :func:`fused_attention_block_q`
(``_attn_block_kernel_q``). Their LN1 is the bf16 chain of the MLP
sub-block kernels (f32 statistics, each operation rounded to bf16), not the
f32 LN of the LN kernels above. Each is a short sequence of launches: the
LN pass, the QKV-projection attention kernel of ``csrc/attention.cu`` on
its output (bf16, or int8 coding each bf16 LN row), then the projection
with bias and residual (int8: after coding the attention output per row).
The bf16 sub-block is differentiable as in JAX: its backward is the VJP of
the plain recompute :func:`attention_block_xla` (f32 LN), with no backward
kernel, as the JAX package has none; the int8 one is inference-only.

Layout: q, k, v are ``[B, H, L, D]``; packed and fused entry points take
and return ``[B, L, C]`` as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ._build import (
    check_no_grad,
    check_tensor,
    cuda_stream,
    load,
    on_cpu,
    raise_on,
)
from .mlp import _ln_bf16_normalise
from .quant import QWeight, int_matmul, quantized_weight, row_codes, true_div

# launches of each CUDA kernel since the last reset (the CPU twin does not count)
LAUNCHES: Dict[str, int] = {
    "packed_attention": 0,
    "qkvproj_attention": 0,
    "ln_qkvproj_attention": 0,
    "packed_attention_bwd": 0,
    "qkvproj_attention_int8": 0,
    "ln_qkvproj_attention_int8": 0,
    "attention_fwd": 0,
    "fused_attention_bwd": 0,
    "attention_block": 0,
    "attention_block_int8": 0,
    "flash": 0,
}

KERNEL_HEAD_DIM = 64
KERNEL_MAX_LEN = 512  # the whole head's q, k, v stay in one SM's shared memory

# the JAX dispatcher: plain math up to this length, then the [B, H, L, D]
# kernel (_fwd_kernel) up to FUSED_MAX_LEN, then _flash_kernel
_XLA_PREFERRED_MAX_LEN = 512
FUSED_MAX_LEN = 1024
FWD_HEAD_DIMS = (32, 64)
# _flash_kernel's key block: the online softmax rescales once per block
FLASH_BLOCK_K = 256
# model-level attn_impl strings that select a fused route in models/layers;
# an unfused call that carries one resolves to auto, as in the JAX dispatcher
MODEL_IMPLS = ("pallas_packed", "pallas_qkvproj", "pallas_block",
               "pallas_lnmlp", "int8")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _default_scale(head_dim: int, scale: Optional[float]) -> float:
    return float(head_dim) ** -0.5 if scale is None else float(scale)


# ---------------------------------------------------------------------------
# Plain path (math attention) — also the probability-readout path
# ---------------------------------------------------------------------------


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, return_probs: bool = False):
    """softmax(q k^T * scale) v with f32 scores and softmax; P is cast to
    v's dtype before P·V (``xla_attention`` of the JAX package)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_probs:
        return out, p
    return out


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The fused kernels' attention core on [B, H, L, D], and the twin of
    the [B, H, L, D] kernel (``_fwd_kernel``): f32 scores ``f32(q k^T) *
    scale``, f32 row max, ``p = exp(s - m)`` and its f32 row sum; ``(p in
    v's dtype) . v`` with f32 sums divided by the sum, rounded once to q's
    dtype. The TPU kernel's row padding to a multiple of 32 and its
    ``-0.7 * f32 max`` key mask change no value (exp of the masked scores
    is exactly 0, padded V rows are zero, padded query rows are dropped),
    so the twin has neither."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float,
                          block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Twin of the blocked online-softmax kernel (``_flash_kernel``) on
    [B, H, L, D], with its recurrence over key blocks of ``block_k``: f32
    scores ``f32(q k^T) * scale``; ``m' = max(m, rowmax)``, ``p = exp(s -
    m')`` and ``alpha = exp(m - m')`` in f32; ``l = alpha l + rowsum(p)``;
    ``o = alpha o + (p in v's dtype) . v`` with f32 sums; at the end ``o /
    l`` rounded once to q's dtype. The TPU kernel's padding of K and V to a
    multiple of ``block_k`` and its ``-0.7 * f32 max`` key mask change no
    value (every block holds a real key, so the row max is a real score and
    exp of a masked one is exactly 0), so the twin slices the last block
    instead."""
    b, h, l, d = q.shape
    qf = q.float()
    m = torch.full((b, h, l, 1), float("-inf"), device=q.device)
    lsum = torch.zeros((b, h, l, 1), device=q.device)
    o = torch.zeros((b, h, l, v.shape[-1]), device=q.device)
    for i in range(0, k.shape[2], block_k):
        s = torch.matmul(qf, k[:, :, i:i + block_k].float().transpose(-1, -2))
        s = s * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
        o = alpha * o + torch.matmul(p.to(v.dtype).float(),
                                     v[:, :, i:i + block_k].float())
        m = m_new
    return (o / lsum).to(q.dtype)


def packed_attention_plain(qkv: torch.Tensor, num_heads: int,
                           scale: float) -> torch.Tensor:
    """Twin of the packed kernel: qkv [B, L, 3HD] -> [B, L, HD]."""
    b, l, c3 = qkv.shape
    h = num_heads
    d = c3 // (3 * h)
    q, k, v = qkv.reshape(b, l, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    o = attention_plain(q, k, v, scale)
    return o.transpose(1, 2).reshape(b, l, h * d)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, scale: float):
    """Twin of the [B, H, L, D] backward kernel (``_bwd_kernel``): dq, dk,
    dv [B, H, L, D] from the forward's inputs and the output cotangent do.
    f32 scores, row max and p = e / l (normalised in f32 before any cast,
    where the forward divides after P·V); dv = bf16(p)ᵀ·dO; delta =
    rowsum(p ⊙ dp) from p and dp = dO·Vᵀ (not from dO ⊙ O); ds = bf16(p ⊙
    (dp − delta)); dq = ds·K·scale, dk = dsᵀ·Q·scale; each rounded once to
    q's dtype. Masked keys have p = 0 and padded query rows a zero
    cotangent, so the TPU kernel's padding changes no value."""
    qf, kf, vf, g = (t.float() for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    del s, e
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), g)
    dp = torch.matmul(g, vf.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    del p, dp
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def packed_attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor,
                               num_heads: int, scale: float) -> torch.Tensor:
    """Twin of the packed backward kernel: dqkv [B, L, 3HD] from the
    forward's input qkv and the output cotangent do [B, L, HD], with the
    arithmetic of :func:`attention_bwd_plain` (``_packed_bwd_kernel``
    rounds where ``_bwd_kernel`` does)."""
    b, l, c3 = qkv.shape
    h = num_heads
    d = c3 // (3 * h)
    q, k, v = qkv.reshape(b, l, 3, h, d).permute(2, 0, 3, 1, 4)
    g = do.reshape(b, l, h, d).transpose(1, 2)
    dqkv = torch.stack(attention_bwd_plain(q, k, v, g, scale))
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, l, c3)


def qkvproj_attention_plain(x: torch.Tensor, w_qkv: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Twin of the QKV-projection kernel: W cast to x's dtype, f32
    accumulation, qkv rounded to x's dtype, then the packed core."""
    w = w_qkv.to(x.dtype)
    qkv = torch.matmul(x.float(), w.float()).to(x.dtype)
    return packed_attention_plain(qkv, num_heads, scale)


def ln_rows_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Twin of the LN pass of the bf16 LN + QKV-projection route: the f32
    LN1 of :func:`_ln_f32` rounded once to x's dtype, the rows that
    :func:`ln_qkvproj_attention_plain` feeds its projection. The kernel
    takes its two f32 sums in lane order (``delta.ln_lanes``)."""
    return _ln_f32(x, ln_scale, ln_bias, eps).to(x.dtype)


def ln_qkvproj_attention_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                               ln_bias: torch.Tensor, w_qkv: torch.Tensor,
                               num_heads: int, scale: float,
                               eps: float) -> torch.Tensor:
    """Twin of the LN + QKV-projection kernel: f32 statistics with
    var = E[x^2] - mu^2, LN output rounded to x's dtype."""
    xln = _ln_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    return qkvproj_attention_plain(xln, w_qkv, num_heads, scale)


def _ln_f32(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LN1 of the fused kernels in f32: f32 statistics (var = E[x^2] -
    mu^2) and an f32 output (the int8 kernel codes it as it is; the bf16
    kernel rounds it to x's dtype)."""
    xf = x.float()
    c = x.shape[-1]
    mu = true_div(xf.sum(dim=-1, keepdim=True), c)
    var = true_div((xf * xf).sum(dim=-1, keepdim=True), c) - mu * mu
    inv = torch.rsqrt(var + eps)
    return (xf - mu) * inv * ln_scale.float() + ln_bias.float()


def _int8_qkv_attention(xf: torch.Tensor, qw: QWeight, num_heads: int,
                        scale: float, dtype: torch.dtype) -> torch.Tensor:
    """The int8 kernels after their prologue: row codes ``round(x * (127 /
    amax))`` (a product, not int8_dense's division), the int32 product,
    ``f32(acc) * (amax * (1/127)) * ws`` rounded to ``dtype`` qkv, then the
    packed attention core."""
    xq, xs = row_codes(xf)
    qkv = (int_matmul(xq, qw.kn).float() * xs * qw.scale).to(dtype)
    return packed_attention_plain(qkv, num_heads, scale)


def qkvproj_attention_int8_plain(x: torch.Tensor, qw: QWeight,
                                 num_heads: int,
                                 scale: float) -> torch.Tensor:
    """Twin of the int8 QKV-projection kernel (``_qkv_attn_kernel_q``):
    x (already LN'd) coded per row in f32."""
    return _int8_qkv_attention(x.float(), qw, num_heads, scale, x.dtype)


def ln_qkvproj_attention_int8_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                                    ln_bias: torch.Tensor, qw: QWeight,
                                    num_heads: int, scale: float,
                                    eps: float) -> torch.Tensor:
    """Twin of the int8 LN + QKV-projection kernel
    (``_qkv_attn_kernel_qln``): LN1 in f32, then as the LN-free twin."""
    return _int8_qkv_attention(_ln_f32(x, ln_scale, ln_bias, eps), qw,
                               num_heads, scale, x.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_x(name: str, x: torch.Tensor, num_heads: int, parts: int) -> None:
    """Limits of the CUDA kernels: x [B, L, parts*H*64] bf16, L <= 512."""
    if x.dim() != 3:
        raise ValueError(f"{name} must be [B, L, C], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA attention kernels take bfloat16, got "
                         f"{x.dtype} (use attn_impl='xla' for other dtypes)")
    if x.shape[-1] != parts * num_heads * KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA attention kernels take head dim "
                         f"{KERNEL_HEAD_DIM}: {name} width {x.shape[-1]} "
                         f"with {num_heads} heads")
    if not 1 <= x.shape[1] <= KERNEL_MAX_LEN:
        raise ValueError(f"the CUDA attention kernels take 1 <= L <= "
                         f"{KERNEL_MAX_LEN}, got {x.shape[1]}")
    check_tensor(name, x, torch.bfloat16, tuple(x.shape), x.device)


def _packed_kernel(qkv: torch.Tensor, num_heads: int,
                   scale: float) -> torch.Tensor:
    b, l, c3 = qkv.shape
    _check_x("qkv", qkv, num_heads, 3)
    out = torch.empty((b, l, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    rc = load("attention").uspace_packed_attention(
        qkv.data_ptr(), out.data_ptr(), b, l, num_heads, scale,
        cuda_stream(qkv.device))
    raise_on(rc, "uspace_packed_attention")
    LAUNCHES["packed_attention"] += 1
    return out


def _packed_bwd_kernel(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                       scale: float) -> torch.Tensor:
    b, l, c3 = qkv.shape
    _check_x("qkv", qkv, num_heads, 3)
    check_tensor("do", do, qkv.dtype, (b, l, c3 // 3), qkv.device)
    dqkv = torch.empty_like(qkv)
    # per-row max, sum and delta, passed from the dQ kernel to the dK/dV one
    stats = torch.empty((b * num_heads * 3 * l,), dtype=torch.float32,
                        device=qkv.device)
    rc = load("attention_bwd").uspace_packed_attention_bwd(
        qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, l,
        num_heads, scale, cuda_stream(qkv.device))
    raise_on(rc, "uspace_packed_attention_bwd")
    LAUNCHES["packed_attention_bwd"] += 1
    return dqkv


def _rows(w: torch.Tensor, shape: tuple, dtype: torch.dtype,
          device: torch.device, name: str) -> torch.Tensor:
    """A [K, N] weight (JAX layout) as the kernels' [N, K] rows in
    ``dtype``; free for the transpose of a torch Linear weight of that
    dtype."""
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(w.shape)}")
    rows = w.to(dtype).t().contiguous()
    check_tensor(name, rows, dtype, shape[::-1], device)
    return rows


def _ln_vectors(ln_scale: torch.Tensor, ln_bias: torch.Tensor, c: int,
                device: torch.device):
    """LN1's scale and bias as the kernels take them: contiguous f32 [C]."""
    lns = ln_scale.to(torch.float32).reshape(-1).contiguous()
    lnb = ln_bias.to(torch.float32).reshape(-1).contiguous()
    check_tensor("ln_scale", lns, torch.float32, (c,), device)
    check_tensor("ln_bias", lnb, torch.float32, (c,), device)
    return lns, lnb


def _ln_rows_kernel(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The LN pass of the bf16 LN + QKV-projection route alone, on rows
    x [..., C] bf16 (C <= 2048); counted by no op, as it is a piece of one."""
    c = x.shape[-1]
    check_tensor("x", x, torch.bfloat16, tuple(x.shape), x.device)
    lns, lnb = _ln_vectors(ln_scale, ln_bias, c, x.device)
    out = torch.empty_like(x)
    raise_on(load("attention").uspace_ln_rows(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), out.data_ptr(),
        x.numel() // c, c, eps, cuda_stream(x.device)), "uspace_ln_rows")
    return out


def _qkv_gemm_kernel(x: torch.Tensor, w_rows: torch.Tensor) -> torch.Tensor:
    """The wgmma projection alone: ``x [..., K] . w_rows [N, K]^T`` in
    bf16 with f32 sums rounded once (K a multiple of 64, N of 8). Counted
    by no op."""
    k = x.shape[-1]
    n = w_rows.shape[0]
    check_tensor("x", x, torch.bfloat16, tuple(x.shape), x.device)
    check_tensor("w_rows", w_rows, torch.bfloat16, (n, k), x.device)
    out = x.new_empty((*x.shape[:-1], n))
    raise_on(load("attention").uspace_qkv_gemm(
        x.data_ptr(), w_rows.data_ptr(), out.data_ptr(), x.numel() // k, n, k,
        cuda_stream(x.device)), "uspace_qkv_gemm")
    return out


def _qkvproj_kernel(x, w_qkv, num_heads, scale):
    b, l, c = x.shape
    _check_x("x", x, num_heads, 1)
    w = _rows(w_qkv, (c, 3 * c), x.dtype, x.device, "w_qkv")
    qkv = x.new_empty((b, l, 3 * c))
    out = torch.empty_like(x)
    rc = load("attention").uspace_qkvproj_attention(
        x.data_ptr(), w.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, l,
        num_heads, scale, cuda_stream(x.device))
    raise_on(rc, "uspace_qkvproj_attention")
    LAUNCHES["qkvproj_attention"] += 1
    return out


def _ln_qkvproj_kernel(x, ln_scale, ln_bias, w_qkv, num_heads, scale, eps):
    b, l, c = x.shape
    _check_x("x", x, num_heads, 1)
    check_no_grad(x, ln_scale, ln_bias, w_qkv,
                  what="the LN + QKV-projection attention kernel")
    w = _rows(w_qkv, (c, 3 * c), x.dtype, x.device, "w_qkv")
    lns, lnb = _ln_vectors(ln_scale, ln_bias, c, x.device)
    xln = torch.empty_like(x)
    qkv = x.new_empty((b, l, 3 * c))
    out = torch.empty_like(x)
    rc = load("attention").uspace_ln_qkvproj_attention(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
        xln.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, l, num_heads,
        scale, eps, cuda_stream(x.device))
    raise_on(rc, "uspace_ln_qkvproj_attention")
    LAUNCHES["ln_qkvproj_attention"] += 1
    return out


def _int8_kernel(x, qw, num_heads, scale, ln=None):
    """The int8 QKV-projection kernel; with ``ln = (scale, bias, eps)`` the
    LN1 variant."""
    b, l, c = x.shape
    _check_x("x", x, num_heads, 1)
    check_tensor("w_qkv codes", qw.q, torch.int8, (3 * c, c), x.device)
    check_tensor("w_qkv scales", qw.scale, torch.float32, (3 * c,), x.device)
    out = torch.empty_like(x)
    lib = load("attention")
    if ln is None:
        rc = lib.uspace_qkvproj_attention_int8(
            x.data_ptr(), qw.q.data_ptr(), qw.scale.data_ptr(),
            out.data_ptr(), b, l, num_heads, scale, cuda_stream(x.device))
        raise_on(rc, "uspace_qkvproj_attention_int8")
        LAUNCHES["qkvproj_attention_int8"] += 1
        return out
    ln_scale, ln_bias, eps = ln
    lns, lnb = _ln_vectors(ln_scale, ln_bias, c, x.device)
    rc = lib.uspace_ln_qkvproj_attention_int8(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), qw.q.data_ptr(),
        qw.scale.data_ptr(), out.data_ptr(), b, l, num_heads, scale, eps,
        cuda_stream(x.device))
    raise_on(rc, "uspace_ln_qkvproj_attention_int8")
    LAUNCHES["ln_qkvproj_attention_int8"] += 1
    return out


def _check_bhld(what: str, q: torch.Tensor) -> None:
    """Limits of the [B, H, L, D] kernels: bf16, head dim 32 or 64,
    1 <= L <= 1024."""
    _, _, l, d = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bfloat16, got {q.dtype} (use "
                         f"attn_impl='xla' for other dtypes)")
    if d not in FWD_HEAD_DIMS:
        raise ValueError(f"{what} takes head dim "
                         f"{' or '.join(map(str, FWD_HEAD_DIMS))}, got {d}")
    if not 1 <= l <= FUSED_MAX_LEN:
        raise ValueError(f"{what} takes 1 <= L <= {FUSED_MAX_LEN}, got {l}")


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float) -> torch.Tensor:
    _check_bhld("the [B, H, L, D] attention kernel", q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, torch.bfloat16, tuple(q.shape), q.device)
    b, h, l, d = q.shape
    out = torch.empty_like(q)
    rc = load("attention_fwd").uspace_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, l, d,
        scale, cuda_stream(q.device))
    raise_on(rc, "uspace_attention_fwd")
    LAUNCHES["attention_fwd"] += 1
    return out


def _fused_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, scale: float):
    _check_bhld("the [B, H, L, D] attention backward kernel", q)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        check_tensor(name, t, torch.bfloat16, tuple(q.shape), q.device)
    b, h, l, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # per-row max, sum and delta of every 64-row tile, passed from the dQ
    # kernel to the dK/dV one
    lp = -(-l // 64) * 64
    stats = torch.empty((b * h * 3 * lp,), dtype=torch.float32,
                        device=q.device)
    rc = load("fused_attention_bwd").uspace_fused_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h,
        l, d, scale, cuda_stream(q.device))
    raise_on(rc, "uspace_fused_attention_bwd")
    LAUNCHES["fused_attention_bwd"] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """The [B, H, L, D] kernel (its twin on the CPU) with the [B, H, L, D]
    backward kernel as VJP, as ``_fused_attention`` of the JAX package: it
    saves only q, k and v, and CPU autograd reproduces the JAX VJP, not
    autograd of the forward twin."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if on_cpu(q):
            return attention_plain(q, k, v, scale)
        return _fwd_kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, g, ctx.scale), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, H, L, D] through the [B, H, L, D]
    kernel (its twin on the CPU): bf16, head dim 32 or 64, L <= 1024;
    strided views are made contiguous first. Differentiable through the
    backward kernel."""
    scale = _default_scale(q.shape[-1], scale)
    return _FusedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale)


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, scale: Optional[float] = None):
    """(dq, dk, dv) [B, H, L, D] of :func:`fused_attention` from its inputs
    and the output cotangent do; P is recomputed, never stored."""
    scale = _default_scale(q.shape[-1], scale)
    if on_cpu(q):
        return attention_bwd_plain(q, k, v, do, scale)
    return _fused_bwd_kernel(q, k, v, do.contiguous(), scale)


def _flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    b, h, l, d = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the blocked attention kernel takes bfloat16, got "
                         f"{q.dtype} (use attn_impl='xla' for other dtypes)")
    if d not in FWD_HEAD_DIMS:
        raise ValueError(f"the blocked attention kernel takes head dim "
                         f"{' or '.join(map(str, FWD_HEAD_DIMS))}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, torch.bfloat16, tuple(q.shape), q.device)
    out = torch.empty_like(q)
    rc = load("flash_attention").uspace_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, l, d,
        scale, cuda_stream(q.device))
    raise_on(rc, "uspace_flash_attention")
    LAUNCHES["flash"] += 1
    return out


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, H, L, D] by the blocked
    online-softmax kernel (its twin :func:`flash_attention_plain` on the
    CPU): bf16, head dim 32 or 64, any L; strided views are made contiguous
    first. Inference-only, as ``flash_attention_blocked`` of the JAX
    package, which defines no VJP: a call that needs a gradient raises
    ``ValueError``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "the blocked attention kernel (_flash_kernel, L > 1024) has no "
            "backward, as in the JAX package (flash_attention_blocked "
            "defines no VJP): call it under torch.no_grad(), or use "
            "impl='xla' to differentiate attention over L > 1024")
    scale = _default_scale(q.shape[-1], scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if on_cpu(q):
        return flash_attention_plain(q, k, v, scale)
    return _flash_kernel(q, k, v, scale)


def packed_attention_bwd(qkv: torch.Tensor, do: torch.Tensor,
                         num_heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """dqkv [B, L, 3*H*D] of packed attention from its input qkv and the
    output cotangent do [B, L, H*D]; P is recomputed, never stored."""
    scale = _default_scale(qkv.shape[-1] // (3 * num_heads), scale)
    if on_cpu(qkv):
        return packed_attention_bwd_plain(qkv, do, num_heads, scale)
    return _packed_bwd_kernel(qkv, do.contiguous(), num_heads, scale)


class _PackedAttention(torch.autograd.Function):
    """The packed kernel (its twin on the CPU) with the packed backward
    kernel as VJP, as ``_packed_attention`` of the JAX package: CPU
    autograd reproduces the JAX VJP, not autograd of the forward twin."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        if on_cpu(qkv):
            return packed_attention_plain(qkv, num_heads, scale)
        return _packed_kernel(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return packed_attention_bwd(qkv, g, ctx.num_heads, ctx.scale), None, None


class _QKVProjAttention(torch.autograd.Function):
    """The QKV-projection kernel with the VJP of ``_qkv_attn_bwd``:
    recompute qkv = x @ W, run the packed backward, then dx and dW are two
    plain matmuls (outside any kernel in the JAX package too)."""

    @staticmethod
    def forward(ctx, x, w, num_heads, scale):
        ctx.save_for_backward(x, w)
        ctx.num_heads, ctx.scale = num_heads, scale
        if on_cpu(x):
            return qkvproj_attention_plain(x, w, num_heads, scale)
        return _qkvproj_kernel(x, w, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        qkv = torch.matmul(x, w)
        dqkv = packed_attention_bwd(qkv, g, ctx.num_heads, ctx.scale)
        dx = torch.matmul(dqkv, w.t()) if ctx.needs_input_grad[0] else None
        dw = (torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                           dqkv.reshape(-1, dqkv.shape[-1]))
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None, None


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """qkv [B, L, 3*H*D] (packed [q|k|v] x heads) -> [B, L, H*D];
    differentiable through the packed backward kernel."""
    d = qkv.shape[-1] // (3 * num_heads)
    return _PackedAttention.apply(qkv, num_heads, _default_scale(d, scale))


def fused_qkvproj_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                            num_heads: int, scale: Optional[float] = None,
                            quant: bool = False) -> torch.Tensor:
    """x [B, L, C] (post-LN) and fused QKV weight [C, 3C] -> attention
    output [B, L, C] (pre out-projection); on the card the bf16 [B, L, 3C]
    qkv makes one round trip through a workspace. W is cast to x's dtype
    first, so its gradient reaches an f32 master weight through the cast.
    ``quant=True``: int8 projection of the f32 weight inside the kernel
    (the qkv never reaches device memory), inference-only."""
    scale = _default_scale(x.shape[-1] // num_heads, scale)
    if quant:
        check_no_grad(x, w_qkv, what="the int8 QKV-projection kernel")
        qw = quantized_weight(w_qkv)
        if on_cpu(x):
            return qkvproj_attention_int8_plain(x, qw, num_heads, scale)
        return _int8_kernel(x, qw, num_heads, scale)
    return _QKVProjAttention.apply(x, w_qkv.to(x.dtype), num_heads, scale)


def fused_ln_qkvproj_attention(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_qkv: torch.Tensor, num_heads: int, scale: Optional[float] = None,
    eps: float = 1e-5, quant: bool = False,
) -> torch.Tensor:
    """``attention(qkv(LN(x)))``. ``quant=False``: the LN rows rounded to
    x's dtype, bf16 projection (W cast to x's dtype); on the card the LN
    rows and the qkv each make one round trip through a workspace.
    ``quant=True``: LN in f32, int8 projection of the f32 weight, all in
    one kernel."""
    scale = _default_scale(x.shape[-1] // num_heads, scale)
    if quant:
        check_no_grad(x, ln_scale, ln_bias, w_qkv,
                      what="the int8 LN + QKV-projection kernel")
        qw = quantized_weight(w_qkv)
        if on_cpu(x):
            return ln_qkvproj_attention_int8_plain(
                x, ln_scale, ln_bias, qw, num_heads, scale, eps)
        return _int8_kernel(x, qw, num_heads, scale, (ln_scale, ln_bias, eps))
    if on_cpu(x):
        return ln_qkvproj_attention_plain(x, ln_scale, ln_bias, w_qkv,
                                          num_heads, scale, eps)
    return _ln_qkvproj_kernel(x, ln_scale, ln_bias, w_qkv, num_heads, scale,
                              eps)


# ---------------------------------------------------------------------------
# The whole attention sub-block (TPU kernels _attn_block_kernel and
# _attn_block_kernel_q): x + proj(attention(qkv(LN1(x))))
# ---------------------------------------------------------------------------


def attention_block_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, w_qkv: torch.Tensor,
                          w_proj: torch.Tensor, b_proj: torch.Tensor,
                          num_heads: int, scale: float,
                          eps: float) -> torch.Tensor:
    """Twin of the bf16 sub-block kernel (``_attn_block_kernel``): LN1 as
    the bf16 chain (rounded after each operation), qkv rounded to x's
    dtype, the attention core, then the projection's f32 sum plus the bias
    rounded to x's dtype, rounded, and the residual add in x's dtype."""
    xln = _ln_bf16_normalise(x, ln_scale, ln_bias, eps).to(x.dtype)
    a = qkvproj_attention_plain(xln, w_qkv, num_heads, scale)
    p = (torch.matmul(a.float(), w_proj.to(x.dtype).float())
         + b_proj.to(x.dtype).float())
    return x + p.to(x.dtype)


def attention_block_int8_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                               ln_bias: torch.Tensor, qw_qkv: QWeight,
                               qw_proj: QWeight, b_proj: torch.Tensor,
                               num_heads: int, scale: float,
                               eps: float) -> torch.Tensor:
    """Twin of the int8 sub-block kernel (``_attn_block_kernel_q``): the
    bf16-chain LN1 rows coded ``round(x * (127 / amax))``, the int8 QKV
    projection dequantized to x's dtype, the attention core; the attention
    output coded per row the same way (over all heads), ``f32(acc) *
    (amax * (1/127)) * s_proj + b_proj`` (f32 bias) rounded to x's dtype,
    and the residual add in x's dtype."""
    xln = _ln_bf16_normalise(x, ln_scale, ln_bias, eps)
    a = _int8_qkv_attention(xln, qw_qkv, num_heads, scale, x.dtype)
    aq, sa = row_codes(a.float())
    p = (int_matmul(aq, qw_proj.kn).float() * sa * qw_proj.scale
         + b_proj.float())
    return x + p.to(x.dtype)


def attention_block_xla(x: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, w_qkv: torch.Tensor,
                        w_proj: torch.Tensor, b_proj: torch.Tensor,
                        num_heads: int, scale: float,
                        eps: float) -> torch.Tensor:
    """The plain recompute whose VJP is the sub-block's backward
    (``_attn_block_xla``): f32 LN1 rounded to x's dtype, qkv in x's dtype,
    :func:`xla_attention`, proj and bias in x's dtype."""
    b, l, c = x.shape
    h = num_heads
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    xln = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale
           + ln_bias).to(x.dtype)
    qkv = torch.matmul(xln, w_qkv.to(x.dtype))
    q, k, v = qkv.reshape(b, l, 3, h, c // h).permute(2, 0, 3, 1, 4)
    a = xla_attention(q, k, v, scale).transpose(1, 2).reshape(b, l, c)
    return x + (torch.matmul(a, w_proj.to(a.dtype))
                + b_proj.to(a.dtype)).to(x.dtype)


def _block_kernel(x, ln_scale, ln_bias, w_qkv, w_proj, b_proj, num_heads,
                  scale, eps, qws=None):
    """Launch the sub-block on x [B, L, C] bf16: bf16, or with ``qws =
    (QWeight of w_qkv, QWeight of w_proj)`` W8A8."""
    b, l, c = x.shape
    _check_x("x", x, num_heads, 1)
    if c % 128:
        raise ValueError(f"the attention sub-block kernels take C a "
                         f"multiple of 128, got {c}")
    dev, r = x.device, b * l
    lns = ln_scale.to(torch.float32).reshape(-1).contiguous()
    lnb = ln_bias.to(torch.float32).reshape(-1).contiguous()
    bp = b_proj.to(torch.float32).reshape(-1).contiguous()
    for name, t in (("ln_scale", lns), ("ln_bias", lnb), ("b_proj", bp)):
        check_tensor(name, t, torch.float32, (c,), dev)
    stream = cuda_stream(dev)
    blk, lib = load("attention_block"), load("attention")
    xln, a, out = (torch.empty_like(x) for _ in range(3))
    raise_on(blk.uspace_ln_bf16(x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                                xln.data_ptr(), r, c, eps, stream),
             "uspace_ln_bf16")
    if qws is None:
        w = _rows(w_qkv, (c, 3 * c), x.dtype, dev, "w_qkv")
        wp = _rows(w_proj, (c, c), x.dtype, dev, "w_proj")
        qkv = x.new_empty((b, l, 3 * c))
        raise_on(lib.uspace_qkvproj_attention(
            xln.data_ptr(), w.data_ptr(), qkv.data_ptr(), a.data_ptr(), b, l,
            num_heads, scale, stream), "uspace_qkvproj_attention")
        raise_on(blk.uspace_proj_residual(
            a.data_ptr(), wp.data_ptr(), bp.data_ptr(), x.data_ptr(),
            out.data_ptr(), r, c, c, stream), "uspace_proj_residual")
        LAUNCHES["attention_block"] += 1
        return out
    qkv_w, proj_w = qws
    for name, qw, n in (("w_qkv", qkv_w, 3 * c), ("w_proj", proj_w, c)):
        check_tensor(f"{name} codes", qw.q, torch.int8, (n, c), dev)
        check_tensor(f"{name} scales", qw.scale, torch.float32, (n,), dev)
    codes = torch.empty((r, c), dtype=torch.int8, device=dev)
    sr = torch.empty((r,), dtype=torch.float32, device=dev)
    raise_on(lib.uspace_qkvproj_attention_int8(
        xln.data_ptr(), qkv_w.q.data_ptr(), qkv_w.scale.data_ptr(),
        a.data_ptr(), b, l, num_heads, scale, stream),
        "uspace_qkvproj_attention_int8")
    raise_on(blk.uspace_row_codes(a.data_ptr(), codes.data_ptr(),
                                  sr.data_ptr(), r, c, stream),
             "uspace_row_codes")
    raise_on(blk.uspace_proj_residual_int8(
        codes.data_ptr(), sr.data_ptr(), proj_w.q.data_ptr(),
        proj_w.scale.data_ptr(), bp.data_ptr(), x.data_ptr(), out.data_ptr(),
        r, c, c, stream), "uspace_proj_residual_int8")
    LAUNCHES["attention_block_int8"] += 1
    return out


class _AttentionBlock(torch.autograd.Function):
    """The bf16 sub-block kernel (its twin on the CPU) with the VJP of
    ``_attn_block_bwd``: autograd of :func:`attention_block_xla`
    recomputed from the saved inputs (f32 LN), not of the forward twin."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, w_proj, b_proj, num_heads,
                scale, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, w_proj, b_proj)
        ctx.args = (num_heads, scale, eps)
        if on_cpu(x):
            return attention_block_plain(x, ln_scale, ln_bias, w_qkv, w_proj,
                                         b_proj, num_heads, scale, eps)
        return _block_kernel(x, ln_scale, ln_bias, w_qkv, w_proj, b_proj,
                             num_heads, scale, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = attention_block_xla(*ins, *ctx.args)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(got) if n else None for n in need), None, None, None)


def fused_attention_block(x: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, w_qkv: torch.Tensor,
                          w_proj: torch.Tensor, b_proj: torch.Tensor,
                          num_heads: int, scale: Optional[float] = None,
                          eps: float = 1e-5) -> torch.Tensor:
    """The pre-norm attention sub-block ``x + proj(attention(qkv(LN(x))))``
    in bf16: x [B, L, C], w_qkv [C, 3C], w_proj [C, C] (JAX layout, as
    ``linear.weight.t()``), b_proj [C]; the weights are rounded to x's
    dtype. Differentiable through the recompute VJP of
    :func:`attention_block_xla`."""
    scale = _default_scale(x.shape[-1] // num_heads, scale)
    return _AttentionBlock.apply(x, ln_scale, ln_bias, w_qkv, w_proj, b_proj,
                                 num_heads, scale, eps)


def fused_attention_block_q(x: torch.Tensor, ln_scale: torch.Tensor,
                            ln_bias: torch.Tensor, w_qkv: torch.Tensor,
                            w_proj: torch.Tensor, b_proj: torch.Tensor,
                            num_heads: int, scale: Optional[float] = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """:func:`fused_attention_block` with int8 W8A8 projections of the f32
    weights (quantized once per weight value). Inference-only."""
    scale = _default_scale(x.shape[-1] // num_heads, scale)
    check_no_grad(x, ln_scale, ln_bias, w_qkv, w_proj, b_proj,
                  what="the int8 attention sub-block kernel")
    qws = (quantized_weight(w_qkv), quantized_weight(w_proj))
    if on_cpu(x):
        return attention_block_int8_plain(x, ln_scale, ln_bias, *qws, b_proj,
                                          num_heads, scale, eps)
    return _block_kernel(x, ln_scale, ln_bias, w_qkv, w_proj, b_proj,
                         num_heads, scale, eps, qws)


# ---------------------------------------------------------------------------
# Public dispatcher
# ---------------------------------------------------------------------------


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
    col_mult: Optional[torch.Tensor] = None,
    return_probs: bool = False,
):
    """Dispatching attention front-end on ``[B, H, L, D]``.

    ``col_mult``: optional ``[B, L]`` post-softmax per-key multiplier
    (prompt-to-prompt rescale), folded exactly into V. ``impl``: ``xla``
    (plain); ``pallas`` — :func:`fused_attention` for L <= 1024,
    :func:`flash_attention_blocked` above; ``auto`` — plain for L <= 512
    and on the CPU, ``pallas`` above 512 on the card, as the JAX package
    routes on the TPU; the model-level strings of :data:`MODEL_IMPLS` (an
    unfused U-ViT attention carries them) resolve to ``auto``.
    """
    scale = _default_scale(q.shape[-1], scale)
    if col_mult is not None:
        # out_i = sum_j p_ij m_j v_j: the column rescale is a V row scale
        v = v * col_mult[:, None, :, None].to(v.dtype)
    if return_probs:
        return xla_attention(q, k, v, scale, return_probs=True)
    if impl in MODEL_IMPLS:
        impl = "auto"
    if impl == "auto":
        impl = ("xla" if q.shape[2] <= _XLA_PREFERRED_MAX_LEN or on_cpu(q)
                else "pallas")
    if impl == "xla":
        return xla_attention(q, k, v, scale)
    if impl == "pallas":
        if q.shape[2] > FUSED_MAX_LEN:
            return flash_attention_blocked(q, k, v, scale)
        return fused_attention(q, k, v, scale)
    raise ValueError(f"unknown impl {impl!r}")
