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

Data parallelism (``torch.distributed`` with more than one process, the
semantics of the JAX package's ``shard_batch_call``: the batch split, the
weights replicated): each process draws the noise of the global batch from
the step's generator and keeps its shard's rows, the gradients and the loss
are averaged over the processes in one all-reduce before the global norm,
the clip and the Adam step, so the non-finite skip is decided on the global
values and every process applies the same update. A 2-process run
reproduces a 1-process run at the same global batch up to the order of the
f32 sums. On one process no collective is launched.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core import flow
from ..core.interpolant import Shard, draw
from ..parallel import distributed
from .state import FusedAdam, Params, TrainState


def sample_from_moments(moments: torch.Tensor, generator: torch.Generator,
                        scale_factor: float = 0.18215,
                        shard: Shard = (0, 1)) -> torch.Tensor:
    """A latent from SD-VAE posterior moments [B, H, W, 2C] (mean ‖
    logvar, logvar clipped to [-30, 20]), times the SD scale factor; the
    noise is a shard's rows of the global batch's draw."""
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    eps = draw(torch.randn, mean.shape, generator, mean.dtype, mean.device,
               shard)
    return (mean + std * eps) * scale_factor


def all_reduce_mean(tensors) -> list:
    """The mean over the processes of each tensor, in one all-reduce of
    their concatenation (every process gets the same bits)."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
        i += t.numel()
    return out


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
    (labels) or 'context' (text embeddings), passed to the model through
    :func:`make_velocity_fn` as the JAX step passes them.
    ``state.params`` must be the model's own parameters.

    ``skip_nonfinite``: when the loss or any gradient is NaN/Inf, params,
    EMA and Adam moments keep their values, ``step`` still advances and
    ``metrics["nonfinite_skip"]`` is 1. ``metrics["lr"]`` is the rate the
    update used, keyed on the applied-update count.

    Under ``torch.distributed`` (more than one process when the step is
    made) the batch is this process's shard of the global batch: see the
    module's docstring."""
    shard = (distributed.process_index(), distributed.process_count())

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        x1 = batch["x"]
        if latents_from_moments:
            x1 = sample_from_moments(x1, generator, vae_scale, shard)
        vf = make_velocity_fn(model, {k: batch.get(k)
                                      for k in ("y", "context")})
        names = list(state.params)
        per_sample = flow.training_loss(vf, x1, sigma_min, generator, shard)
        loss = per_sample.mean()
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        if shard[1] > 1:
            *grads, loss = all_reduce_mean([*grads, loss.detach()])
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


def make_velocity_fn(model: torch.nn.Module, cond: Optional[Dict] = None,
                     **apply_kwargs) -> Callable:
    """Close a denoiser over its conditioning: ``vf(t[B], x) -> velocity``,
    or ``(velocity, taps)`` when ``capture=`` or ``capture_attn=`` asks for
    taps. ``cond`` may hold 'y' (class labels) or 'context'; the other
    keyword arguments (``edit=``, ``attn_edit=``, ``capture=``,
    ``capture_attn=``) pass through to the model
    (``uspace_tpu/train/step.make_velocity_fn``)."""
    cond = cond or {}
    want_aux = bool(apply_kwargs.get("capture")
                    or apply_kwargs.get("capture_attn"))

    def vf(t: torch.Tensor, x: torch.Tensor):
        if cond.get("context") is not None:
            out, taps = model(x, t, cond["context"], **apply_kwargs)
        elif cond.get("y") is not None:
            out, taps = model(x, t, y=cond["y"], **apply_kwargs)
        else:
            out, taps = model(x, t, **apply_kwargs)
        return (out, taps) if want_aux else out

    return vf


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
