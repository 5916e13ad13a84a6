"""Sampling drivers: the classifier-free-guidance field and sample-to-dir.

Counterpart of ``uspace_tpu/evals/sampling.py``. Guidance composes the
conditional and unconditional velocities in one forward over the doubled
batch ``[cond ‖ uncond]`` (one launch per kernel, at twice the batch):

    v = v_uncond + s * (v_cond - v_uncond)
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..train.step import make_velocity_fn
from ..utils.vis import save_image_batch


def _merge_cond(cond: Dict, null_cond: Dict) -> Dict:
    """``cond`` and ``null_cond`` concatenated key by key along the batch.
    A key present in only one of them raises: it would turn the guidance
    into a no-op (both halves unconditional)."""
    merged = {}
    for k in set(cond) | set(null_cond):
        a, b = cond.get(k), null_cond.get(k)
        if a is None and b is None:
            merged[k] = None
        elif a is None or b is None:
            raise ValueError(f"cfg_velocity_fn: conditioning key {k!r} "
                             "present in only one of cond/null_cond")
        else:
            merged[k] = torch.cat([a, b], dim=0)
    return merged


def cfg_velocity_fn(model: torch.nn.Module, cond: Dict, null_cond: Dict,
                    guidance_scale: float, **apply_kwargs) -> Callable:
    """``vf(t[B], x)`` with classifier-free guidance: one forward of
    ``model`` over ``[x ‖ x]`` with ``[cond ‖ null_cond]``; the other keyword
    arguments (``attn_edit=``, ...) pass to the model for the doubled
    batch."""
    merged = _merge_cond(cond, null_cond)
    vf2 = make_velocity_fn(model, merged, **apply_kwargs)

    def vf(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        v_c, v_u = vf2(torch.cat([t, t]), torch.cat([x, x])).chunk(2)
        return v_u + guidance_scale * (v_c - v_u)

    return vf


def sample2dir(sample_fn: Callable[[torch.Generator, int], torch.Tensor],
               n_samples: int, mini_batch_size: int, out_dir: str,
               generator: torch.Generator,
               unpreprocess: Optional[Callable] = None,
               as_npy: bool = False) -> None:
    """``n_samples`` images in mini-batches from ``sample_fn(generator,
    n)`` ([n, H, W, C] in [-1, 1] with ``unpreprocess``, else in [0, 1]),
    written as ``{i}.png``, or with ``as_npy`` as one ``{first index}.npy``
    a batch."""
    for b in range(math.ceil(n_samples / mini_batch_size)):
        n = min(mini_batch_size, n_samples - b * mini_batch_size)
        imgs = sample_fn(generator, n)
        imgs = np.asarray(torch.as_tensor(imgs).float().cpu())
        if unpreprocess is not None:
            imgs = unpreprocess(imgs)
        if as_npy:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"{b * mini_batch_size}.npy"),
                    imgs)
        else:
            save_image_batch(imgs, out_dir, start_index=b * mini_batch_size)


def null_cond(dataset, cond: Dict) -> Dict:
    """The null conditioning of CFG for ``cond`` (the JAX loop's
    ``Experiment.null_cond``, ``uspace_tpu/train/loop.py:325-346``): the
    dataset's ``empty_context`` (zeros where it has none) for a context,
    the learned null class K (its ``null_label`` where set) for labels."""
    null = {}
    ctx = cond.get("context")
    if ctx is not None:
        empty = getattr(dataset, "empty_context", None)
        null["context"] = (torch.zeros_like(ctx) if empty is None else
                           torch.as_tensor(empty, dtype=ctx.dtype,
                                           device=ctx.device)
                           .expand_as(ctx).clone())
    y = cond.get("y")
    if y is not None and getattr(dataset, "K", None):
        # labels 0..K-1 are real: K - 1 would guide against a real class
        label = getattr(dataset, "null_label", None)
        null["y"] = torch.full_like(y, dataset.K if label is None else label)
    return null


def eval_cond(mode: str, dataset, n: int, generator: torch.Generator,
              device=None) -> Dict:
    """Conditioning for evaluation sampling by training mode (the JAX
    loop's ``Experiment.eval_cond``, ``:348-360``): ``t2i`` takes the
    contexts of ``n`` test samples at random indices, a labelled dataset
    ``n`` random labels in [0, K), any other none."""
    if mode == "t2i":
        test = dataset.get_split("test")
        idx = torch.randint(0, len(test), (n,), generator=generator,
                            device=generator.device).cpu().tolist()
        ctx = np.stack([test[i]["context"] for i in idx])
        return {"context": torch.as_tensor(ctx, device=device)}
    if getattr(dataset, "has_label", False):
        return {"y": torch.randint(0, dataset.K, (n,), generator=generator,
                                   device=generator.device).to(device)}
    return {}
