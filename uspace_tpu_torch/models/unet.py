"""Stable-Diffusion UNet velocity field (NHWC).

Counterpart of ``uspace_tpu/models/unet.py``: ResBlocks with (optional
scale-shift) time conditioning, SpatialTransformers (or the legacy QKV
attention block) at the configured downsample rates, a skip-concatenating
decoder and zero-initialised output convs. Activations are NHWC at every
module boundary, as in the JAX package; each conv takes the NCHW view of a
channels-last tensor (``Conv2d.nhwc``). Module and parameter names are the
reference's torch names (``libs/sd/openaimodel.py``), so JAX params load
with ``strict=True`` (``codecs/convert.load_unet_from_jax``).

Self-attention goes through ``ops.attention.multi_head_attention``: on the
card ``auto`` sends 512 < L <= 1024 (the 32x32 levels of UNet-large) to the
[B, H, L, D] kernel, L > 1024 (the 64x64 level at 512 pixels) to the
blocked online-softmax kernel and shorter sequences to plain math, as the
JAX package routes on the TPU; the [B, H, L, D] kernel is differentiable,
so the model trains on its own ``auto`` at 32x32 latents. Cross-attention
is plain math. A missing context becomes a zeros [B, 1, context_dim]
token. ``use_checkpoint`` recomputes each ResBlock, SpatialTransformer
and AttnBlockLegacy in the backward (``torch.utils.checkpoint``,
non-reentrant, only under autograd), as the JAX UNet's ``nn.remat``.

Int8 sampling views (``quant``, the JAX package's ``_conv`` and
``_udense``): ``True``/``"conv8"`` runs the ResBlock 3x3 convs, the
Downsample and Upsample convs and the SpatialTransformer's 1x1
``proj_in``/``proj_out`` as ``Int8Conv``; ``"w8a8"`` adds the CrossAttention
and GEGLU denses as int8 ``Dense``; ``"dense8"`` quantizes those denses
only. The boundary convs, the ResBlock's 1x1 skip, ``emb_layers``,
``time_embed`` and AttnBlockLegacy's Conv1d stay in the compute dtype. The
parameters are the same in every view.

``edit`` (a ``editing.specs.USpaceEdit``) writes at the input latents
(head), the middle block's output (mid) or the output (tail), and
``capture`` reads the same taps, as in the JAX package. An edit keeps every
fused attention route.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from .layers import (
    LN_EPS,
    Conv2d,
    Dense,
    Embedding,
    GroupNorm,
    Int8Conv,
    LayerNorm,
    gelu_exact,
    lecun_normal_,
    timestep_embedding,
)
from .uvit import TAPS

ATTN_IMPLS = ("auto", "xla", "pallas")
QUANT_VIEWS = (False, True, "conv8", "w8a8", "dense8")
GN_EPS = 1e-5  # GroupNorm32 (libs/sd/util.py:238-240)
# the std of the zero-initialised output convs in a random-weight field
# (UNet.init_weights(zero_init_std=...)), as the JAX package's UNet tests
ZERO_INIT_STD = 0.05


def _int8_convs(quant) -> bool:
    return quant is True or quant in ("conv8", "w8a8")


def _int8_denses(quant) -> bool:
    return quant in ("w8a8", "dense8")


def _conv(quant, *args, **kw) -> Conv2d:
    """``Conv2d``, or ``Int8Conv`` in the conv views (same parameters)."""
    return (Int8Conv if _int8_convs(quant) else Conv2d)(*args, **kw)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC x2 nearest upsampling: each pixel repeated 2 x 2
    (``jax.image.resize(..., "nearest")`` at exactly x2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Conv1d(nn.Conv1d):
    """Kernel-1 ``nn.Conv1d`` of the legacy attention block on [B, L, C],
    parameters in ``param_dtype``, computed in ``dtype`` as a dense
    product."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 param_dtype=None, device=None):
        super().__init__(cin, cout, 1, dtype=param_dtype or dtype,
                         device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight[..., 0].to(self.dtype),
                        self.bias.to(self.dtype))


class ResBlock(nn.Module):
    """Residual block with timestep-embedding conditioning
    (openaimodel.py:182-293); ``in_layers`` / ``emb_layers`` /
    ``out_layers`` keep the reference's indices."""

    def __init__(self, cin: int, cout: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, quant=False, **kw):
        super().__init__()
        dev = kw.get("device")
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm(cin, GN_EPS, device=dev), nn.SiLU(),
            _conv(quant, cin, cout, 3, padding=1, **kw))
        width = (2 if use_scale_shift_norm else 1) * cout
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_dim, width, **kw))
        self.out_layers = nn.Sequential(
            GroupNorm(cout, GN_EPS, device=dev), nn.SiLU(), nn.Identity(),
            _conv(quant, cout, cout, 3, padding=1, **kw))
        self.skip_connection = (Conv2d(cin, cout, 1, **kw) if cin != cout
                                else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2].nhwc(F.silu(self.in_layers[0](x)))
        e = self.emb_layers[1](F.silu(emb))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=-1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = F.silu(self.out_layers[0](h + e))
        h = self.out_layers[3].nhwc(h)
        if self.skip_connection is not None:
            x = self.skip_connection.nhwc(x)
        return x + h


class CrossAttention(nn.Module):
    """Q from x, K and V from the context, or from x for self-attention
    (libs/sd/attention.py:149-189)."""

    def __init__(self, dim: int, ctx_dim: int, num_heads: int, head_dim: int,
                 attn_impl: str = "auto", quant=False, **kw):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.attn_impl = attn_impl
        kw = dict(kw, quant=_int8_denses(quant))
        self.to_q = Dense(dim, inner, bias=False, **kw)
        self.to_k = Dense(ctx_dim, inner, bias=False, **kw)
        self.to_v = Dense(ctx_dim, inner, bias=False, **kw)
        self.to_out = nn.Sequential(Dense(inner, dim, **kw), nn.Identity())

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, _ = x.shape
        ctx = x if context is None else context
        lk = ctx.shape[1]
        nh, d = self.num_heads, self.head_dim
        q = self.to_q(x).reshape(b, l, nh, d).transpose(1, 2)
        k = self.to_k(ctx).reshape(b, lk, nh, d).transpose(1, 2)
        v = self.to_v(ctx).reshape(b, lk, nh, d).transpose(1, 2)
        if context is None and l == lk:
            out = multi_head_attention(q, k, v, impl=self.attn_impl)
        else:  # f32 scores and softmax, P in v's dtype, f32 sums
            s = torch.matmul(q.float(), k.float().transpose(-1, -2))
            p = torch.softmax(s * d ** -0.5, dim=-1)
            out = torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)
        return self.to_out[0](out.transpose(1, 2).reshape(b, l, nh * d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, **kw):
        super().__init__()
        self.proj = Dense(dim, 2 * inner, **kw)  # int8 in the dense views

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xx, gate = self.proj(x).chunk(2, dim=-1)
        return xx * gelu_exact(gate)  # the A-S polynomial GELU, in f32


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward, mult 4 (libs/sd/attention.py:192-229)."""

    def __init__(self, dim: int, mult: int = 4, quant=False, **kw):
        super().__init__()
        kw = dict(kw, quant=_int8_denses(quant))
        self.net = nn.Sequential(GEGLU(dim, dim * mult, **kw), nn.Identity(),
                                 Dense(dim * mult, dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, num_heads: int, head_dim: int,
                 attn_impl: str = "auto", quant=False, **kw):
        super().__init__()
        dtype, dev = kw["dtype"], kw.get("device")
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, attn_impl,
                                    quant, **kw)
        self.ff = FeedForwardGEGLU(dim, quant=quant, **kw)
        self.attn2 = CrossAttention(dim, ctx_dim, num_heads, head_dim,
                                    attn_impl, quant, **kw)
        self.norm1, self.norm2, self.norm3 = (
            LayerNorm(dim, LN_EPS, dtype=dtype, device=dev) for _ in range(3))

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """1x1 proj -> transformer blocks over the spatial tokens -> zero-init
    1x1 proj, residual (libs/sd/attention.py:232-277)."""

    def __init__(self, ch: int, ctx_dim: int, num_heads: int, head_dim: int,
                 depth: int = 1, attn_impl: str = "auto", quant=False, **kw):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm(ch, GN_EPS, device=kw.get("device"))
        self.proj_in = _conv(quant, ch, inner, 1, **kw)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, ctx_dim, num_heads, head_dim,
                                  attn_impl, quant, **kw)
            for _ in range(depth))
        self.proj_out = _conv(quant, inner, ch, 1, **kw)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        b, h, w, _ = x.shape
        z = self.proj_in.nhwc(self.norm(x))
        inner = z.shape[-1]
        z = z.reshape(b, h * w, inner)
        for blk in self.transformer_blocks:
            z = blk(z, context)
        return self.proj_out.nhwc(z.reshape(b, h, w, inner)) + x


class AttnBlockLegacy(nn.Module):
    """QKV self-attention block of the non-spatial-transformer configs
    (openaimodel.py:296-430): Conv1d qkv in the legacy [H * (3d)] channel
    layout, zero-init Conv1d proj_out."""

    def __init__(self, ch: int, num_heads: int, attn_impl: str = "auto",
                 **kw):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.norm = GroupNorm(ch, GN_EPS, device=kw.get("device"))
        self.qkv = Conv1d(ch, 3 * ch, **kw)
        self.proj_out = Conv1d(ch, ch, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        l, hn = h * w, self.num_heads
        d = c // hn
        qkv = self.qkv(self.norm(x).reshape(b, l, c))
        qkv = qkv.reshape(b, l, hn, 3 * d).transpose(1, 2)  # per head q|k|v
        q, k, v = qkv.split(d, dim=-1)
        out = multi_head_attention(q, k, v, impl=self.attn_impl)
        out = self.proj_out(out.transpose(1, 2).reshape(b, l, c))
        return x + out.reshape(b, h, w, c)


class Downsample(nn.Module):
    """k3 s2 conv, padded 1 on both sides as torch's Downsample (XLA's
    "SAME" would pad (0, 1) and shift the window grid)."""

    def __init__(self, ch: int, quant=False, **kw):
        super().__init__()
        self.op = _conv(quant, ch, ch, 3, stride=2, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.nhwc(x)


class Upsample(nn.Module):
    """x2 nearest upsampling + k3 conv."""

    def __init__(self, ch: int, quant=False, **kw):
        super().__init__()
        self.conv = _conv(quant, ch, ch, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv.nhwc(upsample_nearest2x(x))


class UNet(nn.Module):
    """SD UNetModel (the reference's constructor surface; NHWC
    activations): ``forward(x, timesteps, context=None, y=None) ->
    (velocity, taps)``."""

    def __init__(
        self,
        image_size: int = 32,
        in_channels: int = 4,
        out_channels: int = 4,
        model_channels: int = 256,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4),
        num_heads: int = -1,
        num_head_channels: int = -1,
        num_classes: Optional[int] = None,
        use_scale_shift_norm: bool = False,
        use_spatial_transformer: bool = True,
        transformer_depth: int = 1,
        context_dim: Optional[int] = 768,
        use_checkpoint: bool = False,
        legacy: bool = True,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        quant=False,
        param_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if not (isinstance(quant, bool) or quant in QUANT_VIEWS):
            raise ValueError(f"unknown quant view {quant!r}; the UNet takes "
                             f"{QUANT_VIEWS}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; the UNet "
                             f"takes {ATTN_IMPLS}")
        self.model_channels = ch0 = model_channels
        self.num_head_channels = num_head_channels
        self.num_heads = num_heads
        self.legacy = legacy
        self.use_spatial_transformer = use_spatial_transformer
        self.context_dim = context_dim
        self.use_checkpoint = use_checkpoint
        self.quant = quant
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        emb_dim = 4 * ch0
        self.time_embed = nn.Sequential(Dense(ch0, emb_dim, **kw), nn.SiLU(),
                                        Dense(emb_dim, emb_dim, **kw))
        self.label_emb = (Embedding(num_classes, emb_dim, **kw)
                          if num_classes is not None else None)

        def res(cin, cout):
            return ResBlock(cin, cout, emb_dim, use_scale_shift_norm, quant,
                            **kw)

        def attn(ch):
            nh, dh = self._heads(ch)
            if use_spatial_transformer:
                return SpatialTransformer(ch, context_dim, nh, dh,
                                          transformer_depth, attn_impl, quant,
                                          **kw)
            return AttnBlockLegacy(ch, nh, attn_impl, **kw)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([Conv2d(in_channels, ch0, 3, padding=1, **kw)])])
        chans, ch, ds = [ch0], ch0, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * ch0)]
                ch = mult * ch0
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(
                    nn.ModuleList([Downsample(ch, quant, **kw)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), ch0 * mult)]
                ch = ch0 * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, quant, **kw))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm(ch, GN_EPS, device=device),
                                 nn.SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1, **kw))

    def _heads(self, ch: int) -> Tuple[int, int]:
        """(heads, head dim) at ``ch`` channels (uspace_tpu/models/unet.py
        ``UNet._heads``)."""
        if self.num_head_channels == -1:
            nh = self.num_heads if self.num_heads != -1 else 8
            return nh, ch // nh
        nh = ch // self.num_head_channels
        dim_head = self.num_head_channels
        if self.legacy:
            dim_head = (ch // nh if self.use_spatial_transformer
                        else self.num_head_channels)
        return nh, dim_head

    def _zero_init_convs(self) -> list:
        """The reference's zero-initialised output convs: every proj_out,
        every ResBlock's out_layers.3 and the final out.2."""
        convs = []
        for mod in self.modules():
            if isinstance(mod, (SpatialTransformer, AttnBlockLegacy)):
                convs.append(mod.proj_out)
            elif isinstance(mod, ResBlock):
                convs.append(mod.out_layers[3])
        return convs + [self.out[2]]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     zero_init_std: float = 0.0) -> "UNet":
        """Seeded random init as the reference's: Flax's LeCun normal
        (``lecun_normal_``) for dense and conv weights, a normal of std
        features^-1/2 for the label embedding (Flax ``nn.Embed``), zero
        biases, unit norm scales, and zero output convs (proj_out,
        out_layers.3, out.2), so that the field starts at zero.
        ``zero_init_std > 0`` draws those output convs from normal x
        ``zero_init_std`` instead, as the JAX package's UNet tests do, so
        that a field with random weights is not zero: for checks and
        random-weight sampling (``ZERO_INIT_STD``), never for training."""
        zero = set(self._zero_init_convs())
        for mod in self.modules():
            if isinstance(mod, (GroupNorm, LayerNorm)):
                mod.weight.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=generator,
                    device=mod.weight.device) * mod.weight.shape[1] ** -0.5)
            elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                if mod in zero:
                    mod.weight.copy_(zero_init_std * torch.randn(
                        mod.weight.shape, generator=generator,
                        device=mod.weight.device) if zero_init_std
                        else torch.zeros_like(mod.weight))
                else:
                    lecun_normal_(mod.weight, generator)
            else:
                continue
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        return self

    def _block(self, m: nn.Module, *args) -> torch.Tensor:
        """A remat unit, recomputed in the backward with use_checkpoint."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(m, *args, use_reentrant=False)
        return m(*args)

    def _run(self, layers: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
             context: Optional[torch.Tensor]) -> torch.Tensor:
        for m in layers:
            if isinstance(m, ResBlock):
                h = self._block(m, h, emb)
            elif isinstance(m, SpatialTransformer):
                h = self._block(m, h, context)
            elif isinstance(m, AttnBlockLegacy):
                h = self._block(m, h)
            elif isinstance(m, Conv2d):
                h = m.nhwc(h)
            else:  # Downsample, Upsample
                h = m(h)
        return h

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        *,
        edit=None,
        capture: Tuple[str, ...] = (),
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: latents [B, H, W, C]; timesteps: [B] flow times in [0, 1];
        context: [B, Lc, context_dim] or None (a zeros token); y: [B] int
        labels (class-conditional only); edit: a u-space write edit applied
        at ``edit.loc`` (the input latents, the middle block's output or the
        output) at the batch's time ``timesteps[0]``; capture: tap names
        whose activations are returned. Returns ``(velocity, taps)``."""
        unknown = set(capture) - set(TAPS)
        if unknown:
            raise ValueError(f"unknown taps {sorted(unknown)}")
        taps: Dict[str, torch.Tensor] = {}
        emb = self.time_embed(timestep_embedding(
            timesteps, self.model_channels).to(self.dtype))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional UNet requires labels y")
            emb = emb + self.label_emb(y)
        if self.use_spatial_transformer and context is None:
            context = torch.zeros((x.shape[0], 1, self.context_dim),
                                  dtype=x.dtype, device=x.device)
        t_scalar = timesteps[0]  # batch-uniform during ODE integration
        if edit is not None and edit.loc == "head":
            x = edit.apply(x, t_scalar)
        if "head" in capture:
            taps["head"] = x
        h, hs = x, []
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        if edit is not None and edit.loc == "mid":
            h = edit.apply(h, t_scalar)
        if "mid" in capture:
            taps["mid"] = h
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=-1), emb,
                          context)
        out = self.out[2].nhwc(F.silu(self.out[0](h)))
        if edit is not None and edit.loc == "tail":
            out = edit.apply(out, t_scalar)
        if "tail" in capture:
            taps["tail"] = out
        return out, taps
