"""U-ViT velocity-field network (unconditional / class-conditional).

Counterpart of ``uspace_tpu/models/uvit.py``: a ViT with long skip
connections over SD-VAE latents. Token layout is ``[label?, time,
patches]``, learned position embedding, depth//2 in-blocks -> mid-block ->
depth//2 out-blocks with skip fusion, then norm -> linear decoder ->
unpatchify -> 3x3 conv. Latents are NHWC.

``capture`` returns the head/mid/tail tap activations, and ``edit`` (a
``editing.specs.USpaceEdit``) writes at its tap before the tap is read,
as in the JAX package. With ``use_checkpoint`` each block is recomputed
in the backward (``torch.utils.checkpoint``, non-reentrant)
except ``remat_exempt`` blocks spread evenly over depth, the JAX package's
exempt set; values and gradients do not depend on either. Without autograd
(sampling) no block is checkpointed.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (
    Block,
    Conv2d,
    Dense,
    Embedding,
    LayerNorm,
    PatchEmbed,
    _qmodes,
    lecun_normal_,
    timestep_embedding,
    unpatchify,
)

TAPS = ("head", "mid", "tail")


def remat_exempt_set(depth: int, remat_exempt: int) -> Set[int]:
    """Indices (in-blocks, mid, out-blocks in order) of the blocks left
    un-rematted: ``remat_exempt`` of the depth + 1, spread evenly
    (``uspace_tpu/models/uvit.py:153-157``)."""
    total = depth + 1
    k = min(remat_exempt, total)
    return {int(j * total / k) for j in range(k)} if k > 0 else set()


class UViT(nn.Module):
    """Velocity field v_theta(x, t[, y]) -> (v, taps)."""

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
        num_classes: int = -1,
        use_checkpoint: bool = False,
        remat_exempt: int = 0,
        conv: bool = True,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        quant=False,
        param_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        _qmodes(quant)
        if quant and param_dtype is None:
            # int8 scales are fitted on f32 weights, as the JAX package's
            param_dtype = torch.float32
        self.quant = quant
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_classes = num_classes
        self.dtype = dtype
        self.extras = 2 if num_classes > 0 else 1
        exempt = remat_exempt_set(depth, remat_exempt)
        self.remat = [use_checkpoint and i not in exempt
                      for i in range(depth + 1)]
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, **kw)
        self.time_embed = (
            nn.Sequential(Dense(embed_dim, 4 * embed_dim, **kw), nn.SiLU(),
                          Dense(4 * embed_dim, embed_dim, **kw))
            if mlp_time_embed else nn.Identity())
        self.label_emb = (Embedding(num_classes, embed_dim, **kw)
                          if num_classes > 0 else None)
        num_patches = (img_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(
            1, self.extras + num_patches, embed_dim,
            dtype=param_dtype or dtype, device=device))

        def block(skip_: bool) -> Block:
            return Block(embed_dim, num_heads, mlp_ratio=mlp_ratio,
                         qkv_bias=qkv_bias, qk_scale=qk_scale, skip=skip_,
                         attn_impl=attn_impl, quant=quant, **kw)

        self.in_blocks = nn.ModuleList(block(False) for _ in range(depth // 2))
        self.mid_block = block(False)
        self.out_blocks = nn.ModuleList(block(True)
                                        for _ in range(depth // 2))
        self.norm = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.decoder_pred = Dense(embed_dim, patch_size ** 2 * in_chans, **kw)
        self.final_layer = (Conv2d(in_chans, in_chans, 3, padding=1, **kw)
                            if conv else None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UViT":
        """Seeded random init: truncated normal (std 0.02, cut at 2 std)
        for dense/embedding weights and pos_embed, Flax's LeCun normal
        (``lecun_normal_``) for convs, zero biases, unit LayerNorm
        scales."""
        def tn(t: torch.Tensor, std: float) -> None:
            buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            nn.init.trunc_normal_(buf, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            t.copy_(buf)

        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                tn(mod.weight, 0.02)
            elif isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
            else:
                continue
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        tn(self.pos_embed, 0.02)
        return self

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        *,
        edit=None,
        capture: Tuple[str, ...] = (),
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: latents [B, H, W, C]; timesteps: [B] flow times in [0, 1];
        y: [B] int labels (class-conditional only); edit: a u-space write
        edit applied at ``edit.loc`` at the batch's time ``timesteps[0]``;
        capture: tap names whose activations are returned. Returns
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
        tokens = [t_emb[:, None, :], x]
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional UViT requires labels y")
            tokens = [self.label_emb(y)[:, None, :]] + tokens
        x = torch.cat(tokens, dim=1) + self.pos_embed.to(self.dtype)

        x = self._trunk(x, t_scalar, edit, capture, taps)
        return self._tail(x, t_scalar, edit, capture, taps), taps

    def _trunk(self, x: torch.Tensor, t_scalar: torch.Tensor, edit,
               capture: Tuple[str, ...], taps: Dict[str, torch.Tensor],
               attn_edit=None, capture_attn: Tuple[int, ...] = ()
               ) -> torch.Tensor:
        """The blocks (in -> mid -> out, ids in call order) with the mid
        tap. A block runs plain (and rematted where ``remat`` says, under
        autograd) unless ``attn_edit`` is given or ``capture_attn`` names
        it: then it takes the time, the edit and its id, and a captured
        block's f32 probabilities go to ``taps["attn_{id}"]``."""
        blocks = [*self.in_blocks, self.mid_block, *self.out_blocks]

        def run(i: int, *args: torch.Tensor) -> torch.Tensor:
            cap = i in capture_attn
            if cap or attn_edit is not None:
                out = blocks[i](*args, t=t_scalar, attn_edit=attn_edit,
                                block_id=i, capture_probs=cap)
                if cap:
                    out, taps[f"attn_{i}"] = out
                return out
            if self.remat[i] and torch.is_grad_enabled():
                return checkpoint(blocks[i], *args, use_reentrant=False)
            return blocks[i](*args)

        half = self.depth // 2
        skips = []
        for i in range(half):
            x = run(i, x)
            skips.append(x)
        x = run(half, x)
        if edit is not None and edit.loc == "mid":
            x = edit.apply(x, t_scalar)
        if "mid" in capture:
            taps["mid"] = x
        for i in range(half + 1, 2 * half + 1):
            x = run(i, x, skips.pop())
        return x

    def _tail(self, x: torch.Tensor, t_scalar: torch.Tensor, edit,
              capture: Tuple[str, ...], taps: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """norm -> decoder -> the patch tokens unpatchified -> final conv,
        then the tail tap."""
        x = self.decoder_pred(self.norm(x))[:, self.extras:, :]
        x = unpatchify(x, self.in_chans)
        if self.final_layer is not None:
            x = self.final_layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if edit is not None and edit.loc == "tail":
            x = edit.apply(x, t_scalar)
        if "tail" in capture:
            taps["tail"] = x
        return x
