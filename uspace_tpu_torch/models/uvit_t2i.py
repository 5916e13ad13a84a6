"""U-ViT-T2I: the text-conditional U-ViT with in-context CLIP tokens.

Counterpart of ``uspace_tpu/models/uvit_t2i.py``. The token layout is
``[1 time, num_clip_token context, num_patches image]`` (334 tokens for the
256-pixel configs); the CLIP embeddings enter through a linear
``context_embed`` (clip_dim -> embed_dim). Blocks are numbered in call order
(in -> mid -> out), the ids an ``editing.specs.AttnEdit`` selects.

An ``attn_edit`` (prompt-to-prompt column rescale) or a block named in
``capture_attn`` takes the unfused attention in every block it reaches, as
in the JAX package: at L <= 512 that is the plain route, which launches no
kernel on the card. ``capture_attn`` returns the named blocks' f32
probabilities [B, H, L, L] in ``taps["attn_{id}"]``. Remat applies only to
the plain, unedited call. ``edit`` and ``capture`` are the head / mid / tail
taps of :class:`~.uvit.UViT`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .layers import Dense, timestep_embedding
from .uvit import TAPS, UViT


class UViTT2I(UViT):
    """Velocity field v_theta(x, t, context) -> (v, taps)."""

    def __init__(
        self,
        img_size: int = 32,
        patch_size: int = 2,
        in_chans: int = 4,
        embed_dim: int = 512,
        depth: int = 16,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        qk_scale: Optional[float] = None,
        mlp_time_embed: bool = False,
        clip_dim: int = 768,
        num_clip_token: int = 77,
        use_checkpoint: bool = False,
        remat_exempt: int = 0,
        conv: bool = True,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        quant=False,
        param_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
            mlp_time_embed=mlp_time_embed, num_classes=-1,
            use_checkpoint=use_checkpoint, remat_exempt=remat_exempt,
            conv=conv, dtype=dtype, attn_impl=attn_impl, quant=quant,
            param_dtype=param_dtype, device=device)
        self.num_clip_token = num_clip_token
        self.extras = 1 + num_clip_token
        num_patches = (img_size // patch_size) ** 2
        pe = self.pos_embed
        self.pos_embed = nn.Parameter(torch.zeros(
            1, self.extras + num_patches, embed_dim, dtype=pe.dtype,
            device=pe.device))
        self.context_embed = Dense(
            clip_dim, embed_dim, dtype=dtype,
            param_dtype=self.decoder_pred.weight.dtype, device=device)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor,
        *,
        edit=None,
        attn_edit=None,
        capture: Tuple[str, ...] = (),
        capture_attn: Tuple[int, ...] = (),
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: latents [B, H, W, C]; timesteps [B]; context [B,
        num_clip_token, clip_dim]; edit: a u-space write edit at its tap;
        attn_edit: a p2p column rescale over the joint token axis;
        capture: tap names; capture_attn: block ids whose attention
        probabilities are returned as ``taps["attn_{id}"]``. Returns
        ``(velocity, taps)``."""
        unknown = set(capture) - set(TAPS)
        if unknown:
            raise ValueError(f"unknown taps {sorted(unknown)}")
        taps: Dict[str, torch.Tensor] = {}
        t_scalar = timesteps[0]  # batch-uniform during ODE integration
        if edit is not None and edit.loc == "head":
            x = edit.apply(x, t_scalar)
        if "head" in capture:
            taps["head"] = x

        x = self.patch_embed(x)
        t_emb = self.time_embed(
            timestep_embedding(timesteps, self.embed_dim).to(self.dtype))
        ctx = self.context_embed(context)
        x = torch.cat([t_emb[:, None, :], ctx, x], dim=1) \
            + self.pos_embed.to(self.dtype)
        x = self._trunk(x, t_scalar, edit, capture, taps, attn_edit,
                        tuple(capture_attn))
        return self._tail(x, t_scalar, edit, capture, taps), taps
