"""Training and sampling steps.

Counterpart of ``uspace_tpu/train/step.py``. One train step: latents drawn
from stored VAE moments, the OT-CFM loss, its gradients, the global
gradient norm, and one fused Adam + EMA pass per parameter tensor. The
non-finite guard and the counters stay on the device (``torch.where``), so
a step makes no host round trip; the metrics are device tensors that the
caller reads when it logs.

Random draws come from the ``torch.Generator`` the caller passes, in this
order: the moments noise, then t, then the path noise (jax.random streams
cannot be reproduced in torch).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core import flow
from .state import FusedAdam, Params, TrainState


def sample_from_moments(moments: torch.Tensor, generator: torch.Generator,
                        scale_factor: float = 0.18215) -> torch.Tensor:
    """A latent from SD-VAE posterior moments [B, H, W, 2C] (mean ‖
    logvar, logvar clipped to [-30, 20]), times the SD scale factor."""
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                      device=mean.device)
    return (mean + std * eps) * scale_factor


@torch.no_grad()
def fused_adam_ema(tx: FusedAdam, state: TrainState, grads: Params,
                   ema_rate: float, ok: Optional[torch.Tensor] = None,
                   grad_norm: Optional[torch.Tensor] = None) -> None:
    """Global-norm clip (``tx.grad_clip``, with the raw gradients' norm
    ``grad_norm``) + (L2 | decoupled) weight decay + Adam moments + bias
    correction + LR + apply + EMA lerp, one pass per parameter tensor, in
    place, with the arithmetic of ``uspace_tpu/train/step._fused_adam_ema``
    after optax's ``clip_by_global_norm``. With ``ok`` (a 0-dim bool on the
    device) false, params, EMA, moments and the update count keep their
    values."""
    st = state.opt_state
    count_inc = st.count + 1
    tf = count_inc.float()
    lr = tx.lr_schedule(st.count)
    b1, b2, eps, wd = tx.b1, tx.b2, tx.eps, tx.weight_decay
    c1 = 1.0 - b1 ** tf
    c2 = 1.0 - b2 ** tf
    keep = (lambda new, old: new) if ok is None else (
        lambda new, old: torch.where(ok, new, old))
    for k, p in state.params.items():
        g, m, v, e = grads[k], st.mu[k], st.nu[k], state.ema_params[k]
        if tx.grad_clip is not None:
            g = torch.where(grad_norm < tx.grad_clip, g,
                            g / grad_norm * tx.grad_clip)
        if wd and tx.mode == "adam":
            g = g + wd * p
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * torch.square(g)
        u = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if wd and tx.mode == "adamw":
            u = u + wd * p
        p2 = p - lr * u
        e2 = e * ema_rate + (1.0 - ema_rate) * p2
        for old, new in ((p, p2), (m, m2), (v, v2), (e, e2)):
            old.copy_(keep(new, old))
    st.count = keep(count_inc, st.count)


def make_train_step(
    model: torch.nn.Module,
    tx: FusedAdam,
    sigma_min: float = 1e-4,
    ema_rate: float = 0.9999,
    lr_schedule: Optional[Callable] = None,
    latents_from_moments: bool = False,
    vae_scale: float = 0.18215,
    skip_nonfinite: bool = True,
) -> Callable:
    """``train_step(state, batch, generator) -> metrics``; batch holds 'x'
    (latents, or moments with ``latents_from_moments``) and optionally 'y'
    (labels). ``state.params`` must be the model's own parameters.

    ``skip_nonfinite``: when the loss or any gradient is NaN/Inf, params,
    EMA and Adam moments keep their values, ``step`` still advances and
    ``metrics["nonfinite_skip"]`` is 1. ``metrics["lr"]`` is the rate the
    update used, keyed on the applied-update count."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        x1 = batch["x"]
        if latents_from_moments:
            x1 = sample_from_moments(x1, generator, vae_scale)
        y = batch.get("y")
        names = list(state.params)
        per_sample = flow.training_loss(
            lambda t, x: model(x, t, y=y)[0], x1, sigma_min, generator)
        loss = per_sample.mean()
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.opt_state.count)
        ok = None
        if skip_nonfinite:
            # a NaN/Inf in any gradient reaches the global norm
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            metrics["nonfinite_skip"] = 1.0 - ok.float()
        fused_adam_ema(tx, state, dict(zip(names, grads)), ema_rate, ok,
                       grad_norm)
        state.step += 1
        return metrics

    return train_step


def make_sample_fn(model: torch.nn.Module, z_shape, sigma_min: float = 1e-4,
                   solver_kwargs: Optional[dict] = None,
                   sample_steps: Optional[int] = None) -> Callable:
    """``sample_fn(generator, n, y=None)``: z ~ N(0, I) of shape
    [n, *z_shape] (NHWC) -> ODE decode -> latents. ``sample_steps``
    overrides the fixed-step count. ``sigma_min`` is kept for config
    parity; sampling does not use it."""
    sk = dict(solver_kwargs or {"solver": "fixed", "solver_fix": "euler",
                                "solver_fix_step": 0.02})
    if sample_steps is not None:
        sk["solver"] = "fixed"
        sk.setdefault("solver_fix", "euler")
        sk["solver_fix_step"] = 1.0 / sample_steps

    @torch.no_grad()
    def sample_fn(generator: torch.Generator, n: int,
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = next(model.parameters()).device
        z = torch.randn((n, *z_shape), generator=generator,
                        dtype=torch.float32, device=dev)
        return flow.decode(lambda t, x: model(x, t, y=y)[0], z, sk)

    return sample_fn
