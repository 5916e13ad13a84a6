"""Carry JAX (Flax) U-ViT, SD-UNet and SD-VAE parameters across into the
port's modules.

The port's own copies of ``uvit_flax_to_torch`` and ``unet_flax_to_torch``
(``uspace_tpu/codecs/convert.py``), and :func:`vae_flax_to_torch`, the
inverse of that module's ``_vae_key_map``: each renames Flax's flat module
names to the reference's torch state-dict keys and maps HWIO conv kernels
to OIHW, Conv1d kernels [k, I, O] to [O, I, k] and dense kernels [in, out]
to weights [out, in]. The ``load_*_from_jax`` functions load the result
with ``strict=True``. Only numpy is needed on the JAX side.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def uvit_flax_to_torch(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """U-ViT Flax params (``{"params": tree}`` or the tree) -> the
    reference's torch state-dict keys and layouts, as numpy arrays."""
    out = {}
    for path, arr in _flatten(params.get("params", params)).items():
        parts = list(path)
        leaf = parts.pop()
        base = ".".join(parts)
        # flat module names back to torch's nested lists
        base = re.sub(r"\bin_blocks_(\d+)", r"in_blocks.\1", base)
        base = re.sub(r"\bout_blocks_(\d+)", r"out_blocks.\1", base)
        base = base.replace("time_embed_fc1", "time_embed.0")
        base = base.replace("time_embed_fc2", "time_embed.2")
        if leaf in ("kernel", "scale", "embedding", "bias"):
            key, arr = _torch_leaf(base, leaf, arr)
            out[key] = arr
        else:  # bare params (pos_embed)
            out[".".join(parts + [leaf])] = arr
    return out


def _torch_leaf(base: str, leaf: str, arr: np.ndarray
                ) -> Tuple[str, np.ndarray]:
    """A Flax leaf under torch module path ``base`` -> (torch key, array)."""
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3:  # Conv1d [k, I, O] -> [O, I, k]
            arr = arr.transpose(2, 1, 0)
        else:
            arr = arr.T
        return f"{base}.weight", arr
    if leaf in ("scale", "embedding"):
        return f"{base}.weight", arr
    return f"{base}.{leaf}", arr


def unet_flax_to_torch(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """SD-UNet Flax params -> the reference's torch state-dict keys
    (``libs/sd/openaimodel.py``). Flax's ``output_blocks_{i}_up`` is
    torch's ``output_blocks.{i}.{j}.conv`` with ``j`` 2 when the block also
    carries an attention block (an ``output_blocks_{i}_1`` sibling), else
    1."""
    flat = _flatten(params.get("params", params))
    has_attn = {m.group(1) for m in (re.fullmatch(r"output_blocks_(\d+)_1",
                                                  p[0]) for p in flat) if m}
    tops = {"time_embed_fc1": "time_embed.0", "time_embed_fc2": "time_embed.2",
            "out_norm": "out.0", "out_conv": "out.2"}
    out = {}
    for path, arr in flat.items():
        top, *mid, leaf = path
        m_down = re.fullmatch(r"input_blocks_(\d+)_0_down", top)
        m_up = re.fullmatch(r"output_blocks_(\d+)_up", top)
        m_seq = re.fullmatch(
            r"(input_blocks|output_blocks|middle_block)_(\d+)(?:_(\d+))?", top)
        if top in tops:
            t_top = tops[top]
        elif m_down:
            t_top = f"input_blocks.{m_down.group(1)}.0.op"
        elif m_up:
            i = m_up.group(1)
            t_top = f"output_blocks.{i}.{2 if i in has_attn else 1}.conv"
        elif m_seq:
            t_top = ".".join(g for g in m_seq.groups() if g is not None)
        else:
            t_top = top  # label_emb
        base = ".".join([t_top] + mid)
        # interior renames (the inverse of the JAX package's _unet_key_map)
        base = re.sub(r"\bblocks_(\d+)\b", r"transformer_blocks.\1", base)
        for a, b in ((".in_norm", ".in_layers.0"),
                     (".in_conv", ".in_layers.2"),
                     (".emb_proj", ".emb_layers.1"),
                     (".out_norm", ".out_layers.0"),
                     (".out_conv", ".out_layers.3"),
                     (".skip", ".skip_connection"), (".to_out", ".to_out.0"),
                     (".ff.geglu_proj", ".ff.net.0.proj"),
                     (".ff.out", ".ff.net.2")):
            base = base.replace(a, b)
        key, t = _torch_leaf(base, leaf, arr)
        out[key] = t
    return out


def vae_flax_to_torch(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """SD-VAE Flax params -> the reference's torch state-dict keys
    (``libs/autoencoder.py``), the inverse of the JAX package's
    ``_vae_key_map``: ``down_0_block_1`` -> ``down.0.block.1``,
    ``up_1_upsample`` -> ``up.1.upsample``, ``mid_attn_1`` ->
    ``mid.attn_1``."""
    out = {}
    for path, arr in _flatten(params.get("params", params)).items():
        *mods, leaf = path
        base = ".".join(mods)
        base = re.sub(r"\b(down|up)_(\d+)_(block|attn)_(\d+)", r"\1.\2.\3.\4",
                      base)
        base = re.sub(r"\b(down|up)_(\d+)_(downsample|upsample)",
                      r"\1.\2.\3", base)
        base = re.sub(r"\bmid_(block_\d+|attn_\d+)", r"mid.\1", base)
        key, t = _torch_leaf(base, leaf, arr)
        out[key] = t
    return out


def unflatten(flat: Mapping[str, np.ndarray], sep: str = "/"
              ) -> Dict[str, Any]:
    """``{"a/b/c": array}`` (an ``.npz`` of JAX params) -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


def _load(model: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    return model


def load_uvit_from_jax(model: nn.Module, params: Mapping[str, Any]
                       ) -> nn.Module:
    """Load a numpy tree of JAX U-ViT params into ``model`` in place
    (``strict=True``); each tensor takes the dtype and device of the
    parameter it fills."""
    return _load(model, uvit_flax_to_torch(params))


def load_unet_from_jax(model: nn.Module, params: Mapping[str, Any]
                       ) -> nn.Module:
    """The same for the SD-UNet (``models.unet.UNet``)."""
    return _load(model, unet_flax_to_torch(params))


def load_vae_from_jax(model: nn.Module, params: Mapping[str, Any]
                      ) -> nn.Module:
    """The same for the SD-VAE (``codecs.vae.AutoencoderKL``)."""
    return _load(model, vae_flax_to_torch(params))
