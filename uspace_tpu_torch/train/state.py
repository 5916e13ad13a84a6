"""Train state, optimizer and LR factories, EMA.

Counterpart of ``uspace_tpu/train/state.py`` without optax. The model owns
its f32 master parameters; :class:`TrainState` holds them by name (the same
tensors, updated in place), with the EMA copy, the Adam moments and the
step counters, all on the model's device. :class:`FusedAdam` carries the
hyperparameters of the one update that ``train.step`` applies in a single
pass per parameter tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FusedAdam:
    """Adam with torch.optim.Adam's L2 (``mode="adam"``: weight decay
    folded into the gradient before the moments) or AdamW's decoupled decay
    (``mode="adamw"``), as optax's ``scale_by_adam`` chains: bias correction
    with ``count + 1``, update ``m̂ / (sqrt(v̂) + eps)``, learning rate
    ``lr_schedule(count)`` before the increment. ``grad_clip``: the raw
    gradients are first scaled as ``optax.clip_by_global_norm`` scales them,
    ``g / ‖g‖ * grad_clip`` where ‖g‖ >= grad_clip."""

    mode: str
    b1: float
    b2: float
    eps: float
    weight_decay: float
    lr_schedule: Schedule
    grad_clip: Optional[float] = None

    def init(self, params: Params) -> "AdamState":
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # applied updates (int32, on the device)
    mu: Params
    nu: Params


def get_lr_schedule(name: str = "customized", base_lr: float = 1e-4,
                    warmup_steps: int = 0,
                    total_steps: int = 1_000_000) -> Schedule:
    """'customized' = linear warmup then constant; 'cosine' = optax's
    ``cosine_decay_schedule(base_lr, total_steps)``. Each maps a step
    count (tensor) to an f32 tensor on its device."""
    if name == "customized":
        if warmup_steps and warmup_steps > 0:
            return lambda step: base_lr * torch.clamp(
                torch.as_tensor(step).float() / warmup_steps, max=1.0)
        return lambda step: torch.full_like(
            torch.as_tensor(step, dtype=torch.float32), base_lr)
    if name == "cosine":
        def cosine(step):
            count = torch.clamp(torch.as_tensor(step).float(),
                                max=float(total_steps))
            return base_lr * (0.5 * (1 + torch.cos(
                math.pi * count / total_steps)))
        return cosine
    raise NotImplementedError(name)


def get_optimizer(name: str = "adam", lr_schedule: Optional[Schedule] = None,
                  betas=(0.9, 0.999), weight_decay: float = 0.0,
                  grad_clip: Optional[float] = None,
                  eps: float = 1e-8) -> FusedAdam:
    """"adam" (L2 folded into the gradient) or "adamw" (decoupled), after
    clipping by the global norm when ``grad_clip`` is given; no schedule
    means a constant 1e-4."""
    if name not in ("adam", "adamw"):
        raise NotImplementedError(name)
    if lr_schedule is None:
        lr_schedule = get_lr_schedule("customized", 1e-4)
    b1, b2 = betas
    return FusedAdam(mode=name, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay, lr_schedule=lr_schedule,
                     grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    """All mutable training state; :meth:`state_dict` is what a checkpoint
    holds."""

    step: torch.Tensor  # train steps taken, skipped ones included (int32)
    params: Params
    ema_params: Params
    opt_state: AdamState

    @classmethod
    def create(cls, params: Params, tx: FusedAdam) -> "TrainState":
        """``params``: the model's parameters by name, e.g.
        ``dict(model.named_parameters())``; they are updated in place."""
        dev = next(iter(params.values())).device
        with torch.no_grad():
            ema = {k: p.detach().clone() for k, p in params.items()}
        return cls(step=torch.zeros((), dtype=torch.int32, device=dev),
                   params=params, ema_params=ema, opt_state=tx.init(params))

    def state_dict(self) -> dict:
        detach = lambda d: {k: v.detach() for k, v in d.items()}
        return dict(step=self.step, params=detach(self.params),
                    ema_params=detach(self.ema_params),
                    opt_state=dict(count=self.opt_state.count,
                                   mu=self.opt_state.mu, nu=self.opt_state.nu))

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy ``sd`` into this state's tensors; every key must match."""
        opt = sd["opt_state"]
        pairs = [(self.params, sd["params"]),
                 (self.ema_params, sd["ema_params"]),
                 (self.opt_state.mu, opt["mu"]), (self.opt_state.nu, opt["nu"])]
        for mine, theirs in pairs:
            if mine.keys() != theirs.keys():
                missing = sorted(mine.keys() - theirs.keys())
                extra = sorted(theirs.keys() - mine.keys())
                raise KeyError(f"checkpoint keys differ: missing {missing}, "
                               f"unexpected {extra}")
        for mine, theirs in pairs:
            for k, v in theirs.items():
                mine[k].copy_(v)
        self.step.copy_(sd["step"])
        self.opt_state.count.copy_(opt["count"])


@torch.no_grad()
def ema_update(params: Params, ema_params: Params,
               rate: float = 0.9999) -> Params:
    """ema <- rate * ema + (1 - rate) * params, in place; returns ema."""
    for k, e in ema_params.items():
        e.copy_(e * rate + (1.0 - rate) * params[k])
    return ema_params
