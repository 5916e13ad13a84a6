"""Train a U-ViT velocity field with OT-CFM on synthetic VAE moments.

The training path of ``uspace_tpu/cli/train_lfm.py`` and
``train/loop.train`` that this port covers so far: f32 master weights with
the config's compute dtype, the config's optimizer, LR schedule and EMA,
latents resampled from moments in every step, ``attn_impl="pallas_packed"``
(the JAX train model's view: XLA projection, packed attention kernel and
its backward kernel) and per-block remat. Batches come from
``SyntheticFeatures`` moments (the feature datasets are not in the
repository). Logs loss, grad_norm and lr per step and writes one checkpoint
to ``<workdir>/ckpts/<step>.pt``. Evaluation sampling, the VAE, FID and
multi-card training come with later slices.

    python -m uspace_tpu_torch.cli.train_lfm --config uvit_large \\
        --n_steps 10 --batch 128 --workdir workdir
    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_smoke \\
        --n_steps 3 --device cpu --workdir /tmp/smoke
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..configs import get_config
from ..data.datasets import SyntheticFeatures
from ..models import get_nnet
from ..train import checkpoint
from ..train.state import TrainState, get_lr_schedule, get_optimizer
from ..train.step import make_train_step


def build_train_model(config: dict, device: torch.device, seed: int = 0,
                      attn_impl: str = "pallas_packed",
                      remat_exempt: Optional[int] = None) -> torch.nn.Module:
    """The config's field with f32 master weights computing in the
    config's dtype, seeded random init."""
    nnet = dict(config["nnet"])
    name = nnet.pop("name")
    if remat_exempt is not None:
        nnet["remat_exempt"] = remat_exempt
    dtype = getattr(torch, config.get("compute_dtype", "float32"))
    model = get_nnet(name, dtype=dtype, param_dtype=torch.float32,
                     attn_impl=attn_impl, device=device, **nnet)
    return model.init_weights(torch.Generator(device=device).manual_seed(seed))


def build_optimizer(config: dict):
    """(FusedAdam, lr schedule) from the config's optimizer blocks."""
    tr, opt, sch = config["train"], config["optimizer"], config["lr_scheduler"]
    if tr.get("grad_clip", -1.0) > 0:
        raise NotImplementedError("grad_clip is not ported")
    lr = get_lr_schedule(sch["name"], opt["lr"],
                         warmup_steps=sch.get("warmup_steps", 0),
                         total_steps=tr["n_steps"])
    tx = get_optimizer(opt["name"], lr, betas=tuple(opt["betas"]),
                       weight_decay=opt["weight_decay"])
    return tx, lr


def run(config: str = "uvit_large", n_steps: int = 10,
        batch: Optional[int] = None, seed: int = 0, workdir: str = "workdir",
        device=None, attn_impl: str = "pallas_packed",
        remat_exempt: Optional[int] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train ``n_steps``; returns ``history`` (per-step loss, grad_norm,
    lr, nonfinite_skip), the ``checkpoint`` path, ``model`` and ``state``.
    ``batch`` defaults to the config's per-card batch, ``remat_exempt`` to
    the config's."""
    dev = resolve_device(device)
    cfg = get_config(config)
    tr = cfg["train"]
    model = build_train_model(cfg, dev, seed, attn_impl, remat_exempt)
    tx, lr = build_optimizer(cfg)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, sigma_min=cfg["dynamic"]["sigma_min"],
                           ema_rate=tr["ema_rate"], lr_schedule=lr,
                           latents_from_moments=tr["from_moments"])
    batch = batch or tr["batch_size"]
    c, h, w = cfg["z_shape"]
    data = SyntheticFeatures(num=max(256, batch), shape=(h, w, 2 * c),
                             seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    history = []
    for i in range(n_steps):
        idx = [(i * batch + j) % len(data) for j in range(batch)]
        x = torch.from_numpy(data.batch(idx)["x"]).to(dev)
        rec = {k: float(v) for k, v in step(state, {"x": x}, gen).items()}
        history.append(rec)
        log(f"step {i + 1}/{n_steps}: loss {rec['loss']:.6f} grad_norm "
            f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e}"
            + (" (non-finite: update skipped)" if rec["nonfinite_skip"] else ""))
    path = checkpoint.save(os.path.join(workdir, "ckpts"), state)
    log(f"checkpoint: {path}")
    return dict(history=history, checkpoint=path, model=model, state=state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="uvit_large")
    ap.add_argument("--n_steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the config's per-card batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="workdir")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--attn_impl", default="pallas_packed")
    ap.add_argument("--remat_exempt", type=int, default=None,
                    help="default: the config's")
    a = ap.parse_args(argv)
    run(a.config, a.n_steps, a.batch, a.seed, a.workdir, a.device,
        a.attn_impl, a.remat_exempt)


if __name__ == "__main__":
    main()
