"""Stable-Diffusion KL autoencoder (the frozen codec), NHWC, f32.

Counterpart of ``uspace_tpu/codecs/vae.py`` (the reference's
``libs/autoencoder.py``): resnet encoder and decoder stacks (ch 128, ch_mult
(1, 2, 4, 4), 2 res blocks, attention in the mid blocks only for the SD
config), the quant convs, and the reparameterised ``sample`` with scale
factor 0.18215. Module and parameter names are the reference's torch names,
so JAX params load with ``strict=True`` (``codecs/convert.load_vae_from_jax``).

Numerics: f32 throughout. A f32 convolution on the card would run in TF32
if cuDNN's ``allow_tf32`` (True by default in PyTorch) were left alone, so
``encode_moments`` and ``decode`` run under :func:`f32_precision`: exact
f32, as JAX computes on the CPU. The int8 decode view (``quant=True``) is the JAX
package's ``_conv3``: the decoder's 3x3 convs (its ResnetBlocks' and
Upsamples') become ``Int8Conv`` (W8A8, f32 output); the 1x1 convs, the
attention projections, the quant convs, the boundary convs and the encoder
stay f32. The parameters are the same in both views.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, GroupNorm, Int8Conv, lecun_normal_
from ..models.unet import upsample_nearest2x

SD_CONFIG = dict(  # libs/autoencoder.py:463-476
    ch=128,
    out_ch=3,
    ch_mult=(1, 2, 4, 4),
    num_res_blocks=2,
    attn_resolutions=(),
    in_channels=3,
    resolution=256,
    z_channels=4,
    double_z=True,
)
SD_EMBED_DIM = 4
SD_SCALE_FACTOR = 0.18215
EPS = 1e-6


@contextlib.contextmanager
def f32_precision():
    """cuDNN convolutions and cuBLAS matmuls of f32 tensors in full f32, not
    TF32; the previous settings come back on exit."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _norm(ch: int, device=None) -> GroupNorm:
    """GroupNorm at gcd(32, C) groups: 32 for every VAE width (all multiples
    of 32), the JAX VAE's ``num_groups=32``."""
    return GroupNorm(ch, EPS, device=device)


def _conv3(quant: bool, cin: int, cout: int, device=None) -> Conv2d:
    """A 3x3 conv (padding 1) of the decoder, int8 in the quant view."""
    return (Int8Conv if quant else Conv2d)(cin, cout, 3, padding=1,
                                            device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, quant: bool = False):
        super().__init__()
        self.norm1 = _norm(cin, device)
        self.conv1 = _conv3(quant, cin, cout, device)
        self.norm2 = _norm(cout, device)
        self.conv2 = _conv3(quant, cout, cout, device)
        self.nin_shortcut = (Conv2d(cin, cout, 1, device=device)
                             if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1.nhwc(F.silu(self.norm1(x)))
        h = self.conv2.nhwc(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut.nhwc(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial positions, plain math
    (autoencoder.py:143-195; no kernel, as in the JAX package)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.norm = _norm(ch, device)
        self.q, self.k, self.v, self.proj_out = (
            Conv2d(ch, ch, 1, device=device) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q, k, v = (m.nhwc(h).reshape(b, hh * ww, c)
                   for m in (self.q, self.k, self.v))
        w = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * c ** -0.5,
                          dim=-1)
        out = torch.matmul(w, v).reshape(b, hh, ww, c)
        return x + self.proj_out.nhwc(out)


class Downsample(nn.Module):
    """k3 s2 conv after torch's asymmetric (0, 1, 0, 1) pad
    (autoencoder.py:53-72)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv.nhwc(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    """x2 nearest upsampling + k3 conv (autoencoder.py:35-50)."""

    def __init__(self, ch: int, device=None, quant: bool = False):
        super().__init__()
        self.conv = _conv3(quant, ch, ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv.nhwc(upsample_nearest2x(x))


def _level(blocks, attns, resample=None, name=""):
    lvl = nn.Module()
    lvl.block = nn.ModuleList(blocks)
    lvl.attn = nn.ModuleList(attns)
    if resample is not None:
        setattr(lvl, name, resample)
    return lvl


def _mid(ch: int, device=None, quant: bool = False) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(ch, ch, device, quant)
    mid.attn_1 = AttnBlock(ch, device)
    mid.block_2 = ResnetBlock(ch, ch, device, quant)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h)))


def _run_level(lvl: nn.Module, h: torch.Tensor) -> torch.Tensor:
    for i, blk in enumerate(lvl.block):
        h = blk(h)
        if len(lvl.attn):
            h = lvl.attn[i](h)
    return h


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 in_channels: int = 3, resolution: int = 256,
                 z_channels: int = 4, double_z: bool = True, device=None):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, device=device)
        self.down = nn.ModuleList()
        cin, res = ch, resolution
        for i, mult in enumerate(ch_mult):
            cout = ch * mult
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, cout, device))
                cin = cout
                if res in attn_resolutions:
                    attns.append(AttnBlock(cout, device))
            last = i == len(ch_mult) - 1
            self.down.append(_level(blocks, attns,
                                    None if last else Downsample(cout, device),
                                    "downsample"))
            if not last:
                res //= 2
        self.mid = _mid(cin, device)
        self.norm_out = _norm(cin, device)
        self.conv_out = Conv2d(cin, (2 if double_z else 1) * z_channels, 3,
                               padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in.nhwc(x)
        for lvl in self.down:
            h = _run_level(lvl, h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out.nhwc(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, z_channels: int = 4, device=None,
                 quant: bool = False):
        super().__init__()
        n = len(ch_mult)
        cin = ch * ch_mult[-1]
        res = resolution // 2 ** (n - 1)
        self.conv_in = Conv2d(z_channels, cin, 3, padding=1, device=device)
        self.mid = _mid(cin, device, quant)
        levels = [None] * n
        for i in reversed(range(n)):
            cout = ch * ch_mult[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, cout, device, quant))
                cin = cout
                if res in attn_resolutions:
                    attns.append(AttnBlock(cout, device))
            levels[i] = _level(blocks, attns,
                               Upsample(cout, device, quant) if i else None,
                               "upsample")
            if i:
                res *= 2
        self.up = nn.ModuleList(levels)  # indexed by level, run from the top
        self.norm_out = _norm(cin, device)
        self.conv_out = Conv2d(cin, out_ch, 3, padding=1, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in.nhwc(z))
        for lvl in reversed(self.up):
            h = _run_level(lvl, h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample(h)
        return self.conv_out.nhwc(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """Frozen SD KL-VAE (reference FrozenAutoencoderKL,
    autoencoder.py:412-460). NHWC; moments are [B, h, w, 2 * embed_dim]
    (mean | logvar on the channel axis); exact f32 on the card.
    ``quant=True``: the int8 decode view (sampling only)."""

    def __init__(self, ddconfig: Optional[dict] = None,
                 embed_dim: int = SD_EMBED_DIM,
                 scale_factor: float = SD_SCALE_FACTOR, quant: bool = False,
                 device=None):
        super().__init__()
        cfg = dict(ddconfig or SD_CONFIG)
        self.scale_factor = scale_factor
        common = dict(ch=cfg["ch"], ch_mult=tuple(cfg["ch_mult"]),
                      num_res_blocks=cfg["num_res_blocks"],
                      attn_resolutions=tuple(cfg["attn_resolutions"]),
                      resolution=cfg["resolution"],
                      z_channels=cfg["z_channels"], device=device)
        self.encoder = Encoder(in_channels=cfg.get("in_channels", 3),
                               double_z=cfg.get("double_z", True), **common)
        self.decoder = Decoder(out_ch=cfg.get("out_ch", 3), quant=bool(quant),
                               **common)
        zc = cfg["z_channels"]
        self.quant_conv = Conv2d(2 * zc, 2 * embed_dim, 1, device=device)
        self.post_quant_conv = Conv2d(embed_dim, zc, 1, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        """Seeded random init: Flax's LeCun normal (``lecun_normal_``) for
        the conv weights, zero biases, unit norm scales."""
        for mod in self.modules():
            if isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
                mod.bias.zero_()
        return self

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Pixels [B, H, W, 3] in [-1, 1] -> moments [B, h, w, 2 * embed]."""
        with f32_precision():
            return self.quant_conv.nhwc(self.encoder(x.float()))

    def sample(self, moments: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Scaled latents ``scale_factor * (mean + std * eps)``, logvar
        clipped to [-30, 20], eps from ``generator``."""
        mean, logvar = moments.chunk(2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return self.scale_factor * (mean + std * eps)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.sample(self.encode_moments(x), generator)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, z_channels] -> pixels [B, H, W, 3]."""
        with f32_precision():
            return self.decoder(self.post_quant_conv.nhwc(
                z.float() / self.scale_factor))
