"""Int8 W8A8 quantization of the sampling view (counterpart of
``uspace_tpu/ops/quant.py``).

Scheme, as in the JAX package: weights get symmetric per-output-channel
scales, activations symmetric per-row scales computed on the fly, and the
int32 product is dequantized as ``acc * row_scale * col_scale``. Rounding
is half to even (``torch.round``, like ``jnp.round``) and codes are clipped
to +-127.

:func:`int8_dense` is a plain int8 matmul outside any kernel (the JAX
package leaves it to XLA): ``torch._int_mm`` on the card, an exact product
otherwise. :func:`int8_conv` (the SD-UNet's and the SD-VAE's int8 conv
views) is the same product over im2col windows, with one activation scale
per image.

Weight cache. XLA hoists ``quantize_colwise(w)`` out of the ODE scan, so a
solve quantizes each weight once. The port keeps the same promise with
:func:`quantized_weight`: one quantization per weight value. The codes
are kept on the tensor behind the weight (a view such as
``linear.weight.t()`` finds its parameter's), stamped with the view, its
data pointer and its ``_version``, so an in-place update, a
``load_state_dict`` or a move to another device re-quantizes. They die with
their parameter. :data:`QUANTIZATIONS` counts the quantizations made.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

QMAX = 127.0

# weight quantizations made by the cache since the last reset
QUANTIZATIONS: Dict[str, int] = {"weights": 0}


def reset_quantizations() -> None:
    QUANTIZATIONS["weights"] = 0


def true_div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, as ``jnp`` and the kernels' ``__fdiv_rn``
    divide, on every device: PyTorch's CUDA kernels turn a division by a
    Python scalar into a product with its reciprocal, and ``scalar /
    tensor`` is ``reciprocal(tensor) * scalar``. Scalars become 0-dim
    tensors on the other operand's device (filled there: no host copy)."""
    t = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=t.dtype, device=t.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=t.dtype, device=t.device)
    return torch.div(a, b)


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8: ``(q int8 [..., K], scale f32
    [..., 1])`` with ``x ~= q * scale``; ``x / (amax / 127)``."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    scale = true_div(amax, QMAX)
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def row_codes(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernels' per-row int8 codes of f32 rows: ``round(x * (127
    / amax))``, a product with a quotient rounded once (not
    :func:`quantize_rowwise`'s division by a rounded scale), and the row
    scale ``amax * (1/127)``."""
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    xq = torch.round(xf * true_div(QMAX, amax)).to(torch.int8)
    return xq, amax * (1.0 / QMAX)


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a ``[K, N]`` (JAX layout)
    weight: ``(q int8 [K, N], scale f32 [N])``."""
    wf = w.float()
    amax = torch.clamp(wf.abs().amax(dim=0), min=1e-8)
    scale = true_div(amax, QMAX)
    q = torch.clamp(torch.round(wf / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of ``a [..., K]`` and ``b [K,
    N]``. On the card ``torch._int_mm`` where its shape rules hold (more
    than 16 rows, K and N multiples of 8); otherwise a float64 product,
    exact because every partial sum is an integer below 2**53."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    n = b.shape[-1]
    if a.is_cuda and a2.shape[0] > 16 and k % 8 == 0 and n % 8 == 0:
        # one layout only: row-major a, column-major b (b.t() contiguous)
        out = torch._int_mm(a2.contiguous(), b.t().contiguous().t())
    else:
        out = torch.matmul(a2.double(), b.double()).to(torch.int32)
    return out.reshape(*lead, n)


def int8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
                w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(xq * x_scale) @ (wq * w_scale)``: one int8 product, then
    ``f32(acc) * x_scale * w_scale``."""
    acc = int_matmul(xq, wq)
    return (acc.float() * x_scale * w_scale).to(out_dtype)


def strip_colsums(wq: torch.Tensor, strips: int) -> torch.Tensor:
    """f32 ``[strips, N]``: the int32 column sums of each of ``strips`` row
    strips of the codes ``wq [K, N]`` (exact below 2**24), what an affine
    input grid's zero point multiplies. Kept on the tensor behind the codes
    and made again when they change."""
    base = wq._base if wq._base is not None else wq
    stamp = (wq._version, wq.data_ptr(), tuple(wq.shape), tuple(wq.stride()),
             wq.device, strips)
    held = getattr(base, "_strip_colsums", None)
    if held is not None and held[0] == stamp:
        return held[1]
    k, n = wq.shape
    cs = (wq.reshape(strips, k // strips, n).sum(dim=1, dtype=torch.int32)
          .float().contiguous())
    base._strip_colsums = (stamp, cs)
    return cs


class QWeight:
    """A weight ``w [K, N]`` (JAX layout) quantized per output channel:
    ``q`` int8 ``[N, K]`` (the torch Linear layout the kernels read,
    contiguous), ``scale`` f32 ``[N]``. :meth:`colsums` adds what only the
    codes determine: :func:`strip_colsums` of ``w``'s codes."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def kn(self) -> torch.Tensor:
        """The codes as ``[K, N]`` (a view)."""
        return self.q.t()

    def colsums(self, strips: int) -> torch.Tensor:
        return strip_colsums(self.kn, strips)


def _quantize(w: torch.Tensor) -> QWeight:
    q, scale = quantize_colwise(w)
    QUANTIZATIONS["weights"] += 1
    return QWeight(q.t().contiguous(), scale.contiguous())


def _quantize_conv(w: torch.Tensor) -> QWeight:
    """A conv weight [O, I, kh, kw] as the :class:`QWeight` of its im2col
    product: codes ``[O, kh * kw * I]`` in the (kh, kw, I) order of
    :func:`_im2col`'s columns."""
    q, scale = quantize_convwise(w)
    QUANTIZATIONS["weights"] += 1
    return QWeight(q.permute(0, 2, 3, 1).reshape(q.shape[0], -1).contiguous(),
                   scale.contiguous())


def _cached(w: torch.Tensor, attr: str, make) -> QWeight:
    base = w._base if w._base is not None else w
    stamp = (w._version, w.data_ptr(), tuple(w.shape), tuple(w.stride()),
             w.dtype, w.device)
    held = getattr(base, attr, None)
    if held is not None and held[0] == stamp:
        return held[1]
    with torch.no_grad():
        qw = make(w.detach())
    setattr(base, attr, (stamp, qw))
    return qw


def quantized_weight(w: torch.Tensor) -> QWeight:
    """The :class:`QWeight` of ``w [K, N]``, quantized once per value."""
    return _cached(w, "_int8_codes", _quantize)


def quantized_conv_weight(w: torch.Tensor) -> QWeight:
    """The :class:`QWeight` of a conv weight ``w [O, I, kh, kw]`` (per
    output channel, as :func:`quantize_convwise`), quantized once per
    value."""
    return _cached(w, "_int8_conv_codes", _quantize_conv)


def quantize_convwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a torch conv weight ``[O, I, kh,
    kw]`` (the JAX package's HWIO kernel, transposed): ``(q int8 [O, I, kh,
    kw], scale f32 [O])``, ``scale = amax / 127`` rounded once."""
    wf = w.float()
    amax = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-8)
    scale = true_div(amax, QMAX)
    q = torch.clamp(torch.round(wf / scale[:, None, None, None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


# im2col rows x columns per chunk of images (int8 bytes): the 3x3 convs of
# the SD VAE at 256 x 256 and 128 channels take 3.8 GB of columns and 1.7 GB
# of int32 sums at batch 50 in one piece
_IM2COL_CHUNK = 1 << 30


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride, padding
            ) -> torch.Tensor:
    """NHWC int8 codes -> ``[B, Ho, Wo, kh * kw * C]`` windows, zero
    padded (0 is the code of 0, so padding is exact)."""
    ph, pw = padding
    xp = torch.nn.functional.pad(xq, (0, 0, pw, pw, ph, ph))
    cols = xp.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
    return cols.permute(0, 1, 2, 4, 5, 3).flatten(3)  # [B, Ho, Wo, kh, kw, C]


def image_codes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_conv`'s activation codes of NHWC ``x``: one scale per
    image (amax over H, W and C: a window mixes pixels, so only a per-image
    scale factors out of the int32 sum), ``(clip(round(x / xs), +-127)
    int8, xs = amax / 127 f32 [B, 1, 1, 1])``."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=(1, 2, 3), keepdim=True), min=1e-8)
    xs = true_div(amax, QMAX)
    return torch.clamp(torch.round(xf / xs), -QMAX, QMAX).to(torch.int8), xs


def int8_conv(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride=(1, 1),
              padding=(0, 0), out_dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """W8A8 convolution of NHWC ``x`` with the full-precision weight ``w
    [O, I, kh, kw]`` (quantized once through the cache), as the JAX
    package's ``int8_conv``: :func:`image_codes` of x, an exact int32
    product of the im2col windows with the weight codes (``int_matmul``:
    ``torch._int_mm`` on the card), then ``(f32(acc) * xs) * ws + f32(b)``,
    cast once to ``out_dtype`` (x's dtype)."""
    out_dtype = out_dtype or x.dtype
    xq, xs = image_codes(x)
    qw = quantized_conv_weight(w)
    kh, kw = w.shape[2:]
    per_image = (xq.shape[1] * xq.shape[2] // (stride[0] * stride[1])
                 * qw.q.shape[1])
    n = max(1, _IM2COL_CHUNK // max(1, per_image))
    parts = [int_matmul(_im2col(c, kh, kw, stride, padding), qw.kn)
             for c in xq.split(n)]
    acc = parts[0] if len(parts) == 1 else torch.cat(parts)
    y = acc.float() * xs * qw.scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_dense(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Quantized ``x @ w + b`` with ``w [K, N]`` the full-precision weight
    (quantized once through the cache): row-quantize x, one int8 product,
    ``f32(acc) * xs * ws + f32(b)``, cast to ``out_dtype`` (x's dtype)."""
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_rowwise(x)
    qw = quantized_weight(w)
    y = int8_matmul(xq, xs, qw.kn, qw.scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)
