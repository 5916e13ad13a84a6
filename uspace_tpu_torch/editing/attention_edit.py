"""T2I attention editing: p2p target ids, the local-prompt caption
rewrite, and attention-map extraction and pictures.

Counterpart of ``uspace_tpu/editing/attention_edit.py`` (the reference's
``tools/utils_t2i.py``): caption -> target token ids, the lp_replace /
lp_remove / lp_add rewrite, and per-token heatmaps. The rescale itself is
:class:`~.specs.AttnEdit`, folded into V by the attention op. The token
layout (1 time + 77 context + 256 image tokens at 256 pixels) is a
parameter here, not a constant.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codecs.clip_text import get_word_inds
from .specs import AttnEdit, p2p_col_mult


def local_prompt_rewrite(captions: Sequence[str], token_kwargs: Dict
                         ) -> List[str]:
    """lp_replace / lp_remove / lp_add caption rewriting
    (``tools/utils_t2i.py:299-322``); any other ``token_dissect`` leaves
    the captions as they are."""
    td = token_kwargs.get("token_dissect")
    if td == "lp_replace":
        return [c.replace(token_kwargs["lp_replace_from"],
                          token_kwargs["lp_replace_to"]) for c in captions]
    if td == "lp_remove":
        return [c.replace(token_kwargs["lp_to_remove"], " ")
                for c in captions]
    if td == "lp_add":
        return [c + " , " + token_kwargs["lp_to_add"] for c in captions]
    return list(captions)


def phrase_target_ids(captions: Sequence[str], phrase: str, tokenizer,
                      max_targets: int = 8) -> np.ndarray:
    """Per-caption context-token indices of ``phrase``'s words, padded with
    -1 to [B, max_targets] int32 (context-relative: ``p2p_col_mult`` adds
    the time token). ``"ids:1,4"`` names the indices themselves for every
    caption and needs no tokenizer, so the p2p flows run on contexts that
    are not CLIP text (the synthetic datasets)."""
    out = np.full((len(captions), max_targets), -1, np.int32)
    if phrase.startswith("ids:"):
        ids = [int(tok) for tok in phrase[4:].split(",") if tok.strip()]
        out[:, :min(len(ids), max_targets)] = ids[:max_targets]
        return out
    for b, cap in enumerate(captions):
        ids: List[int] = []
        for word in phrase.split(" "):
            ids.extend(int(i) for i in get_word_inds(cap, word, tokenizer))
        for j, i in enumerate(ids[:max_targets]):
            out[b, j] = i
    return out


def build_p2p_edit(batch: int, seq_len: int, target_ids: np.ndarray,
                   multiplier, t_edit: float = 1.0,
                   block_ids: Optional[Tuple[int, ...]] = None,
                   time_tokens: int = 1, device=None) -> AttnEdit:
    """The :class:`AttnEdit` of a p2p rescale (``tools/utils_t2i.py:
    241-262``), its multiplier on ``device``."""
    mult = p2p_col_mult(batch, seq_len, target_ids, multiplier,
                        time_tokens=time_tokens, device=device)
    return AttnEdit(col_mult=mult, t_edit=t_edit, block_ids=block_ids)


def slice_context_attention(probs: torch.Tensor, num_img_tokens: int = 256,
                            num_context_tokens: int = 77) -> torch.Tensor:
    """[B, H, L, L] probabilities -> the image-query x context-key block
    averaged over heads, [B, img, ctx] (what the reference pictures)."""
    img_q = probs[:, :, -num_img_tokens:, :]
    ctx_k = img_q[:, :, :, -(num_context_tokens + num_img_tokens):
                  -num_img_tokens]
    return ctx_k.mean(dim=1)


def attention_heatmaps(ctx_attn: torch.Tensor) -> torch.Tensor:
    """[B, img, ctx] -> [B, ctx, h, h] heatmaps over the square grid of
    image tokens, each normalised to [0, 1]."""
    b, n_img, n_ctx = ctx_attn.shape
    h = int(round(n_img ** 0.5))
    maps = ctx_attn.transpose(1, 2).reshape(b, n_ctx, h, h)
    mn = maps.amin(dim=(2, 3), keepdim=True)
    mx = maps.amax(dim=(2, 3), keepdim=True)
    return (maps - mn) / torch.clamp(mx - mn, min=1e-8)


def save_attention_maps(ctx_attn, out_dir: str, captions: Sequence[str],
                        tokenizer=None, timestep: Optional[float] = None,
                        block_id: Optional[int] = None,
                        max_tokens: int = 20) -> None:
    """One PNG a caption: its per-token heatmaps in a row (the reference's
    ``vis_attention_map``), named after the caption, the block and the
    time."""
    from ..utils.vis import make_grid, save_image

    maps = attention_heatmaps(torch.as_tensor(ctx_attn).float()).cpu()
    maps = maps.numpy()
    tag = ""
    if block_id is not None:
        tag += f"_block{block_id}"
    if timestep is not None:
        tag += f"_time{timestep:.2f}"
    for b, cap in enumerate(captions):
        toks = None
        if tokenizer is not None:
            toks = [tokenizer.decode([t]) for t in tokenizer.encode(cap)]
        n = min(max_tokens, maps.shape[1] if toks is None else len(toks))
        grid = make_grid(maps[b, :n, :, :, None], nrow=n)
        name = cap[:40].replace(" ", "_").replace("/", "_")
        save_image(grid, os.path.join(out_dir, f"{name}{tag}.png"))
