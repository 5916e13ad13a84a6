"""Shared denoiser layers: time embedding, patch ops, transformer blocks.

Counterpart of ``uspace_tpu/models/layers.py`` as ``nn.Module``s. Latents
are NHWC at the public functions, as in the JAX package; convolutions
permute to NCHW inside. Parameter names follow the reference's torch
state-dict keys, so JAX params load with ``strict=True``
(``codecs/convert.load_uvit_from_jax``).

Numerics follow the Flax modules: a layer built with ``dtype`` keeps its
dense, conv and embedding parameters in ``param_dtype`` (``dtype`` unless
given; f32 master weights for training) and casts its input, weight and
bias to ``dtype`` at each call (Flax's ``promote_dtype``), so no f32 copy
of an activation is made and the gradient reaches the master weight
through the cast. LayerNorm keeps f32 parameters and f32 statistics.

Quantized sampling views (``quant``, the JAX package's ``_qmodes``):
``True``/``"w8a8"`` runs int8 W8A8 on the block matmuls (qkv, proj, MLP,
skip_linear) where the JAX package does, ``"w8a8_mlp"`` on the MLP only,
and ``"w8"`` keeps int8 weights with activations in the compute dtype on
the MLP only (qkv, proj and skip_linear stay bf16 ``Dense``);
:class:`Int8Conv` is the SD-UNet's and the SD-VAE's int8 conv. The param
tree is the bf16 view's, so one checkpoint loads into every view; the int8
layers quantize their f32 weights once per weight value
(``ops/quant.quantized_weight``). ``Block`` follows the JAX routing
(``uspace_tpu/models/layers.py:364-518``), including its less obvious
choices: the unfused attention keeps bf16 qkv and proj, ``pallas_packed``
keeps a bf16 qkv but an int8 proj, ``w8`` and ``w8a8_mlp`` on the LN-fused
route pair the bf16 LN kernel with their MLP sub-block, ``pallas_lnmlp``
with a qkv bias sends ``w8a8_mlp`` to the ``w8`` MLP, and ``pallas_block``
runs the whole attention sub-block in one kernel (W8A8: the int8 one and
the int8 MLP sub-block; every other view: the bf16 one and its own
``Mlp``), or with a qkv bias the unfused attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    fused_attention_block,
    fused_attention_block_q,
    fused_ln_qkvproj_attention,
    fused_qkv_attention,
    fused_qkvproj_attention,
    multi_head_attention,
)
from ..ops.mlp import fused_mlp, fused_mlp_block_q, gelu_exact
from ..ops.quant import int8_conv, int8_dense

# torch defaults the reference relies on: LayerNorm eps=1e-5, exact GELU
LN_EPS = 1e-5
# the std of a unit normal truncated at +-2 (Flax's variance_scaling divides
# by it, so that its truncated draw has the std it asks for)
TRUNC_NORMAL_STD = 0.87962566103423978

ATTN_IMPLS = ("auto", "xla", "pallas_qkvproj", "pallas_packed",
              "pallas_lnmlp", "pallas_block")
QUANT_VIEWS = (False, True, "w8a8", "w8", "w8a8_mlp")


def _qmodes(quant) -> tuple:
    """``(w8a8, w8, a8mlp)`` of the ``quant`` view flag
    (``uspace_tpu/models/layers.py:189-204``)."""
    if not any(quant is v or (isinstance(v, str) and quant == v)
               for v in QUANT_VIEWS):
        raise ValueError(f"unknown quant view {quant!r}")
    return ((quant is True or quant == "w8a8"), quant == "w8",
            quant == "w8a8_mlp")


def _fused_ok(x: torch.Tensor) -> bool:
    """``auto`` mode runs the fused CUDA kernels on the card, as the JAX
    package runs its Pallas kernels on the TPU only."""
    return x.is_cuda


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order (cos first)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], feature order (p1, p2, C)."""
    b, h, w, c = imgs.shape
    p = patch_size
    x = imgs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, channels: int) -> torch.Tensor:
    """[B, L, p*p*C] -> [B, H, W, C] (inverse of :func:`patchify`)."""
    b, l, d = x.shape
    p = int(round((d // channels) ** 0.5))
    hw = int(round(l ** 0.5))
    if hw * hw != l or p * p * channels != d:
        raise ValueError(f"cannot unpatchify {tuple(x.shape)} into "
                         f"{channels} channels")
    x = x.reshape(b, hw, hw, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hw * p, hw * p, channels)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` (the default of ``nn.Dense`` and ``nn.Conv``)
    into ``w``: a normal truncated at +-2 of its scale, scale fan_in^-1/2 /
    0.8796, so the drawn std is fan_in^-1/2. fan_in is ``w[0].numel()``:
    ``in`` of a Linear, ``I * kh * kw`` of a torch conv (Flax's ``H * W *
    I``)."""
    std = w[0].numel() ** -0.5 / TRUNC_NORMAL_STD
    buf = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(buf, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    w.copy_(buf)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with parameters in ``param_dtype`` that computes in
    ``dtype``; with ``quant=True`` the JAX package's ``Int8Dense`` (same
    parameters, W8A8 through :func:`int8_dense`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype=None,
                 device=None, quant: bool = False):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype or dtype, device=device)
        self.dtype = dtype
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self.int8(x)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        _cast(self.bias, self.dtype))

    def int8(self, x: torch.Tensor) -> torch.Tensor:
        """W8A8 ``x @ W + b`` in ``dtype`` (x row-quantized as it comes)."""
        return int8_dense(x, self.weight.t(), self.bias, out_dtype=self.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) with parameters in ``param_dtype`` that
    computes in ``dtype``; :meth:`nhwc` takes and returns NHWC."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 param_dtype=None, device=None, **kw):
        super().__init__(*args, dtype=param_dtype or dtype, device=device,
                         **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                                  _cast(self.bias, self.dtype))

    def nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on NHWC ``x``: the NCHW view of a channels-last tensor
        in, the NHWC view of the result out."""
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Int8Conv(Conv2d):
    """The JAX package's ``Int8Conv``: W8A8 through :func:`int8_conv` (one
    activation scale per image, per-output-channel weight codes, int32
    sums), output in ``dtype``. Its parameters are :class:`Conv2d`'s, f32
    unless ``param_dtype`` says otherwise, so one state dict loads into
    either view."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 param_dtype=None, device=None, **kw):
        super().__init__(*args, dtype=dtype,
                         param_dtype=param_dtype or torch.float32,
                         device=device, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def nhwc(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv(x, self.weight, self.bias, self.stride, self.padding,
                         out_dtype=self.dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` with its table in ``param_dtype``, looked up in
    ``dtype``."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32,
                 param_dtype=None, device=None):
        super().__init__(num, dim, dtype=param_dtype or dtype, device=device)
        self.dtype = dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight.to(self.dtype))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: f32 statistics (var = E[x^2] - mu^2, clamped
    at 0), f32 scale and bias, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = LN_EPS,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                          min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Flax ``nn.GroupNorm`` on NHWC ``x`` (channels last): ``gcd(32, C)``
    groups of channels (the JAX UNet's rule), f32
    statistics over space and the group with var = E[x^2] - mu^2 clamped
    at 0 (Flax's fast variance; torch's ``group_norm`` takes the variance
    another way), ``(x - mu) * (rsqrt(var + eps) * scale) + bias`` in f32,
    then x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    g = math.gcd(32, c)
    xf = x.float().reshape(b, -1, g, c // g)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mu * mu,
                      min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps)
                     * weight.float().reshape(g, c // g))
    return (y + bias.float().reshape(g, c // g)).reshape(x.shape).to(x.dtype)


class GroupNorm(nn.Module):
    """:func:`group_norm` with f32 scale and bias (torch names ``weight``
    and ``bias``); eps 1e-5 in the UNet, 1e-6 in the VAE."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> fc2; a quantized view runs the
    fused int8 MLP (``ops.mlp.fused_mlp``): weight-only for ``"w8"``, W8A8
    for the others."""

    def __init__(self, in_features: int, hidden_dim: int,
                 out_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, quant=False,
                 param_dtype=None, device=None):
        super().__init__()
        w8 = _qmodes(quant)[1]
        self.quant = ("w8" if w8 else True) if quant else False
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc1 = Dense(in_features, hidden_dim, **kw)
        self.fc2 = Dense(hidden_dim, out_dim or in_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return fused_mlp(x.to(self.dtype), self.fc1.weight.t(),
                             self.fc1.bias, self.fc2.weight.t(),
                             self.fc2.bias, quant=self.quant)
        return self.fc2(gelu_exact(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention with fused QKV."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", quant=False, param_dtype=None,
                 device=None):
        super().__init__()
        self.w8a8 = _qmodes(quant)[0]
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv_bias = qkv_bias
        self.attn_impl = attn_impl
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, **kw)
        self.proj = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        h = self.num_heads
        use_fused = self.attn_impl in (
            "pallas_packed", "pallas_qkvproj", "pallas_lnmlp") or (
            self.attn_impl == "auto" and _fused_ok(x))
        if use_fused:
            if not self.qkv_bias and self.attn_impl != "pallas_packed":
                # QKV projection inside the kernel; weight.t() is the JAX
                # [C, 3C] layout and costs no copy. The int8 kernel fits its
                # scales on the f32 weight, as the JAX package does.
                if self.w8a8:
                    out = fused_qkvproj_attention(
                        x, self.qkv.weight.t(), h, self.scale, quant=True)
                else:
                    out = fused_qkvproj_attention(
                        x.to(self.qkv.dtype), self.qkv.weight.t(), h,
                        self.scale)
            else:
                out = fused_qkv_attention(self.qkv(x), h, self.scale)
            return self.proj.int8(out) if self.w8a8 else self.proj(out)
        # the unfused route keeps bf16 qkv and proj in every view (JAX too)
        qkv = self.qkv(x).reshape(b, l, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = multi_head_attention(qkv[0], qkv[1], qkv[2], scale=self.scale,
                                   impl=self.attn_impl)
        return self.proj(out.transpose(1, 2).reshape(b, l, c))


class Block(nn.Module):
    """Pre-norm transformer block with optional long-skip fusion."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 skip: bool = False, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", quant=False, param_dtype=None,
                 device=None):
        super().__init__()
        self.w8a8, self.w8, self.a8mlp = _qmodes(quant)
        self.quant = bool(quant)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.qkv_bias = qkv_bias
        self.skip_linear = (Dense(2 * dim, dim, quant=self.w8a8, **kw)
                            if skip else None)
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, attn_impl=attn_impl,
                              quant=quant, **kw)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), quant=quant, **kw)

    def _mlp_block_q(self, x: torch.Tensor, quant=True) -> torch.Tensor:
        """x + MLP(LN2(x)) in one int8 kernel (``fused_mlp_block_q``): W8A8
        (``quant=True``) or weight-only (``"w8"``)."""
        return fused_mlp_block_q(
            x, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.t(),
            self.mlp.fc1.bias, self.mlp.fc2.weight.t(), self.mlp.fc2.bias,
            eps=self.norm2.eps, quant=quant)

    def _block_route(self, x: torch.Tensor) -> torch.Tensor:
        """The whole attention sub-block in one kernel
        (``uspace_tpu/models/layers.py:376-392``, ``:470-497``): W8A8 runs
        the int8 sub-block, then the int8 MLP sub-block; the other views
        the bf16 sub-block, then their own ``Mlp`` after LN2 (plain bf16,
        the w8 MLP, or the int8 MLP of ``w8a8_mlp``)."""
        a, n1 = self.attn, self.norm1
        args = (x.to(self.dtype), n1.weight, n1.bias, a.qkv.weight.t(),
                a.proj.weight.t(), a.proj.bias, a.num_heads)
        if self.w8a8:
            x = fused_attention_block_q(*args, scale=a.scale, eps=n1.eps)
            return self._mlp_block_q(x)
        x = fused_attention_block(*args, scale=a.scale, eps=n1.eps)
        return x + self.mlp(self.norm2(x))

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.skip_linear is not None:
            x = self.skip_linear(torch.cat([x, skip], dim=-1))
        if self.attn_impl == "pallas_block" and not self.qkv_bias:
            return self._block_route(x)
        # LN-fused route: explicit, or `auto` for a quantized view on the
        # card (the JAX package's int8 view on its accelerator)
        lnfused = (self.attn_impl == "pallas_lnmlp" or (
            self.quant and self.attn_impl == "auto" and _fused_ok(x))) \
            and not self.qkv_bias
        if lnfused:
            # LN1 folds into the attention kernel
            a = fused_ln_qkvproj_attention(
                x.to(self.dtype), self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight.t(), self.attn.num_heads,
                scale=self.attn.scale, eps=self.norm1.eps, quant=self.w8a8)
            if self.w8a8:
                x = x + self.attn.proj.int8(a).to(x.dtype)
                return self._mlp_block_q(x)
            x = x + self.attn.proj(a).to(x.dtype)
            if self.w8 or self.a8mlp:
                return self._mlp_block_q(x, "w8" if self.w8 else True)
            return x + self.mlp(self.norm2(x))  # bf16: LN2 feeds the plain MLP
        x = x + self.attn(self.norm1(x))
        if self.quant and self.attn_impl == "pallas_lnmlp":
            # reached with qkv_bias; the JAX package sends w8a8_mlp to "w8"
            return self._mlp_block_q(x, True if self.w8a8 else "w8")
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Patchifying conv embed: NHWC [B, H, W, C] -> tokens [B, L, E]."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"{tuple(x.shape)} is not a multiple of patch "
                             f"{p}")
        y = self.proj(x.permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2)
