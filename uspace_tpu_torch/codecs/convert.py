"""Carry JAX (Flax) U-ViT parameters across into the port's modules.

The port's own copy of ``uvit_flax_to_torch`` (``uspace_tpu/codecs/
convert.py``): it renames Flax's flat module names to the reference's
torch state-dict keys, maps HWIO conv kernels to OIHW and dense kernels
[in, out] to weights [out, in]. :func:`load_uvit_from_jax` loads the result
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
        if leaf == "kernel":
            out[f"{base}.weight"] = (arr.transpose(3, 2, 0, 1)
                                     if arr.ndim == 4 else arr.T)
        elif leaf in ("scale", "embedding"):
            out[f"{base}.weight"] = arr
        elif leaf == "bias":
            out[f"{base}.bias"] = arr
        else:  # bare params (pos_embed)
            out[".".join(parts + [leaf])] = arr
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


def load_uvit_from_jax(model: nn.Module, params: Mapping[str, Any]
                       ) -> nn.Module:
    """Load a numpy tree of JAX U-ViT params into ``model`` in place
    (``strict=True``); each tensor takes the dtype and device of the
    parameter it fills."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in uvit_flax_to_torch(params).items()}
    model.load_state_dict(sd, strict=True)
    return model
