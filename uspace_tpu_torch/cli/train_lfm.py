"""Train a U-ViT or SD-UNet velocity field with OT-CFM on synthetic VAE
moments.

The training path of ``uspace_tpu/cli/train_lfm.py`` and
``train/loop.train`` that this port covers so far: f32 master weights with
the config's compute dtype and the reference init, the config's optimizer
(global-norm clipping where ``train.grad_clip`` > 0), LR schedule and EMA,
latents resampled from moments in every step. The attention route follows
the JAX loop's rule (:func:`train_attn_impl`): the U-ViT trains on
``"pallas_packed"`` (XLA projection, packed attention kernel and its
backward kernel) with per-block remat, the SD-UNet on its own ``"auto"``
(the [B, H, L, D] kernel and its backward kernel at L = 1024); a config
whose ``nnet.attn_impl`` is ``"pallas_block"`` trains the U-ViT through the
whole attention sub-block kernel and its recompute backward. Batches
come from ``SyntheticFeatures`` moments (the feature datasets are not in
the repository). Logs loss, grad_norm and lr per step and writes one
checkpoint to ``<workdir>/ckpts/<step>.pt``. Evaluation sampling, the VAE,
FID and multi-card training come with later slices.

    python -m uspace_tpu_torch.cli.train_lfm --config uvit_large \\
        --n_steps 10 --batch 128 --workdir workdir
    python -m uspace_tpu_torch.cli.train_lfm --config unet_large \\
        --n_steps 10 --workdir workdir
    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_unet \\
        --n_steps 3 --device cpu --workdir /tmp/unet
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


def train_attn_impl(config: dict) -> str:
    """The attention route a config trains on, by the JAX loop's rule
    (``uspace_tpu/train/loop.py:81-87``): the config's ``nnet.attn_impl``
    where it names one, else ``"pallas_packed"``, except for the SD-UNet
    (``unet_t2i``), which trains on its own ``"auto"``."""
    nnet = config["nnet"]
    if "attn_impl" in nnet:
        return nnet["attn_impl"]
    return "auto" if nnet["name"] == "unet_t2i" else "pallas_packed"


def build_train_model(config: dict, device: torch.device, seed: int = 0,
                      attn_impl: Optional[str] = None,
                      remat_exempt: Optional[int] = None) -> torch.nn.Module:
    """The config's field with f32 master weights computing in the
    config's dtype, the reference's seeded random init (the UNet's output
    convs zero); ``attn_impl`` defaults to :func:`train_attn_impl`."""
    nnet = dict(config["nnet"])
    name = nnet.pop("name")
    nnet["attn_impl"] = attn_impl or train_attn_impl(config)
    if remat_exempt is not None:
        nnet["remat_exempt"] = remat_exempt
    dtype = getattr(torch, config.get("compute_dtype", "float32"))
    model = get_nnet(name, dtype=dtype, param_dtype=torch.float32,
                     device=device, **nnet)
    return model.init_weights(torch.Generator(device=device).manual_seed(seed))


def build_optimizer(config: dict):
    """(FusedAdam, lr schedule) from the config's optimizer blocks; a
    ``train.grad_clip`` above 0 clips by the global norm."""
    tr, opt, sch = config["train"], config["optimizer"], config["lr_scheduler"]
    gc = tr.get("grad_clip", -1.0)
    lr = get_lr_schedule(sch["name"], opt["lr"],
                         warmup_steps=sch.get("warmup_steps", 0),
                         total_steps=tr["n_steps"])
    tx = get_optimizer(opt["name"], lr, betas=tuple(opt["betas"]),
                       weight_decay=opt["weight_decay"],
                       grad_clip=gc if gc and gc > 0 else None)
    return tx, lr


def run(config="uvit_large", n_steps: int = 10,
        batch: Optional[int] = None, seed: int = 0, workdir: str = "workdir",
        device=None, attn_impl: Optional[str] = None,
        remat_exempt: Optional[int] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train ``n_steps`` of ``config`` (a config's name or the config
    itself); returns ``history`` (per-step loss, grad_norm, lr,
    nonfinite_skip), the ``checkpoint`` path, ``model`` and ``state``.
    ``batch`` defaults to the config's per-card batch, ``attn_impl`` to
    :func:`train_attn_impl`, ``remat_exempt`` to the config's (U-ViT)."""
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
    ap.add_argument("--attn_impl", default=None,
                    help="default: pallas_packed (U-ViT), auto (SD-UNet), or "
                    "the config's nnet.attn_impl")
    ap.add_argument("--remat_exempt", type=int, default=None,
                    help="default: the config's")
    a = ap.parse_args(argv)
    run(a.config, a.n_steps, a.batch, a.seed, a.workdir, a.device,
        a.attn_impl, a.remat_exempt)


if __name__ == "__main__":
    main()
