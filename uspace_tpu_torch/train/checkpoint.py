"""Checkpoints, resume and pretrained-weight import (counterpart of
``uspace_tpu/train/checkpoint.py``).

The JAX package checkpoints with orbax; this port's format is one
``torch.save`` file of state dicts (params, EMA params, Adam moments and
counts, and the train step's generator state) at ``<ckpt_dir>/<step>.pt``.
``params`` loads into a fresh model with ``load_state_dict(...,
strict=True)``. :class:`CheckpointManager` keeps the step-indexed files of
one run, written atomically by process 0 only, and :func:`try_resume`
continues from the latest (the reference's ``TrainState.resume``,
utils_uvit.py:211-222). :func:`load_pretrained_nnet` initialises a field
from a reference torch checkpoint with the reference's weight surgeries
(utils_uvit.py:140-209).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from ..codecs.convert import load_torch_checkpoint
from ..parallel import distributed
from ..utils.logging_utils import logger
from .state import TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _write(path: str, state: TrainState) -> str:
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def save(ckpt_dir: str, state: TrainState) -> str:
    """Write ``state`` to ``<ckpt_dir>/<step>.pt`` (atomically); returns
    the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    return _write(os.path.join(ckpt_dir, f"{int(state.step)}.pt"), state)


def load(path: str, map_location=None) -> dict:
    """The state dict saved at ``path`` (tensors only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore(path: str, state: TrainState) -> TrainState:
    """Copy the checkpoint at ``path`` into ``state``; every key must
    match."""
    state.load_state_dict(load(path, map_location=state.step.device))
    return state


class CheckpointManager:
    """Step-indexed TrainState checkpoints ``<ckpt_root>/<step>.pt``.
    Process 0 writes; every process reads. ``max_to_keep`` (None: all)
    deletes the oldest files beyond that many after each save."""

    def __init__(self, ckpt_root: str, max_to_keep: Optional[int] = None):
        self.ckpt_root = os.path.abspath(ckpt_root)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_root, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_root, f"{int(step)}.pt")

    def save(self, state: TrainState, step: Optional[int] = None,
             wait: bool = False) -> str:
        """Write ``state`` as step ``step`` (default ``state.step``) on
        process 0, atomically; returns the path. Saves are synchronous, so
        ``wait`` only makes every process meet after the write."""
        step = int(state.step) if step is None else int(step)
        path = self.path(step)
        if distributed.process_index() == 0:
            _write(path, state)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        if wait:
            self.wait()
        return path

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in (
            _STEP_FILE.match(f) for f in os.listdir(self.ckpt_root)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reached_preemption(self, step: int, requested: bool = False) -> bool:
        """True on every process when any process latched a stop
        (``requested``, its ``GracefulShutdown`` flag) by this step
        boundary, so that under ``torch.distributed`` all stop at the same
        step and the final save is not mismatched; on one process,
        ``requested`` itself (False without it)."""
        del step  # every process calls this at the same step boundary
        return distributed.any_process(requested)

    def _file(self, step: Optional[int]) -> str:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.ckpt_root}")
        return self.path(step)

    def restore(self, state_like: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Copy step ``step`` (default the latest) into ``state_like`` in
        place and return it; FileNotFoundError without a checkpoint."""
        return restore(self._file(step), state_like)

    def restore_params(self, step: Optional[int] = None, ema: bool = True,
                       map_location=None) -> Dict[str, torch.Tensor]:
        """Only the (EMA) parameters of step ``step`` (default the latest),
        by name, without the training optimizer's structure: the loader
        for evaluation and export."""
        raw = load(self._file(step), map_location=map_location)
        key = "ema_params" if ema else "params"
        if key not in raw:
            raise KeyError(f"checkpoint {self._file(step)} has no {key!r}")
        return raw[key]

    def wait(self) -> None:
        distributed.barrier("checkpoint")

    def close(self) -> None:
        self.wait()


def try_resume(mgr: CheckpointManager, state: TrainState) -> TrainState:
    """Resume from the latest checkpoint if any (reference
    ``TrainState.resume``, utils_uvit.py:211-222): ``state`` in place,
    the draw generator's position included where the file has it."""
    step = mgr.latest_step()
    if step is None:
        return state
    sd = load(mgr.path(step), map_location=state.step.device)
    if state.rng is not None and "rng" not in sd:
        logger.warning("checkpoint %s holds no generator state: the resumed "
                       "run's draws differ from an uninterrupted run's",
                       mgr.path(step))
    state.load_state_dict(sd)
    return state


# --- pretrained torch-weight initialization (weight surgery) ---------------

SURGERIES = (None, "nnet_only", "mscoco_or_in256", "unet",
             "unet_remove_attention")


def load_pretrained_nnet(path: str, model: torch.nn.Module,
                         surgery: Optional[str] = None) -> torch.nn.Module:
    """Initialise ``model`` in place from a reference torch checkpoint.

    surgery:
      - None: strict load (U-ViT family): every parameter of ``model`` must
        be in the file
      - "nnet_only": drop label_emb + pos_embed (utils_uvit.py:140-155)
      - "mscoco_or_in256": drop pos_embed (utils_uvit.py:156-166)
      - "unet": an SD / guided-diffusion UNet checkpoint
      - "unet_remove_attention": the UNet with its cross-attention
        re-initialised (load_sd_unet_remove_attention, utils_uvit.py:
        168-209)

    Dropped keys keep their fresh initialisation. A tensor whose shape
    differs from the model's raises ValueError; keys the model lacks are
    reported and ignored (the JAX package's ``merge_params``)."""
    if surgery not in SURGERIES:
        raise ValueError(f"unknown surgery {surgery!r}")
    prefixes = {"nnet_only": ("label_emb", "pos_embed"),
                "mscoco_or_in256": ("pos_embed",)}.get(surgery, ())

    def dropped(k: str) -> bool:
        if surgery == "unet_remove_attention" and ".attn2." in k:
            return True
        return any(k.startswith(p) for p in prefixes)

    sd = load_torch_checkpoint(path)
    own = model.state_dict()
    used, unused = set(), []
    with torch.no_grad():
        for k, v in sd.items():
            if dropped(k):
                continue
            if k not in own:
                unused.append(k)
                continue
            if tuple(own[k].shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: "
                                 f"{tuple(own[k].shape)} vs {tuple(v.shape)}")
            own[k].copy_(v)
            used.add(k)
    if surgery is None and used != own.keys():
        missing = sorted(own.keys() - used)
        raise KeyError(f"{path} lacks {len(missing)} of the model's tensors: "
                       f"{missing[:8]}")
    if unused:
        logger.warning("%d checkpoint tensors matched no parameter "
                       "(key-mapping drift?): %s", len(unused), unused[:8])
    return model
