"""Train a U-ViT or SD-UNet velocity field with OT-CFM on a config's
dataset.

The training path of ``uspace_tpu/cli/train_lfm.py`` and
``train/loop.train`` that this port covers so far: f32 master weights with
the config's compute dtype and the reference init, the config's optimizer
(global-norm clipping where ``train.grad_clip`` > 0), LR schedule and EMA,
latents resampled from moments in every step (raw latents where
``train.from_moments`` is False). The attention route follows the JAX
loop's rule (:func:`train_attn_impl`): the U-ViT trains on
``"pallas_packed"`` (XLA projection, packed attention kernel and its
backward kernel) with per-block remat, the SD-UNet on its own ``"auto"``
(the [B, H, L, D] kernel and its backward kernel at L = 1024); a config
whose ``nnet.attn_impl`` is ``"pallas_block"`` trains the U-ViT through the
whole attention sub-block kernel and its recompute backward. Batches come
from the config's ``dataset`` (its train split) through
``data/loader.DataLoader`` seeded with the config's seed, shuffled epochs
one after the other, as the JAX loop feeds them
(``uspace_tpu/train/loop.py:59-69``, ``:399``); a config whose own
features are not in the repository names synthetic moments. Logs loss,
grad_norm and lr at step 1, every ``train.log_interval`` steps and the
last, and writes one checkpoint to ``<workdir>/ckpts/<step>.pt`` (its EMA
weights are what ``cli/dissect_common.load_nnet_params`` loads).
One loop serves every mode: the batches' class labels (``cond``, the
``synthetic_class`` toy) or text contexts (``t2i``: U-ViT-T2I and the
SD-UNet) reach the field as the JAX step passes them, each with the CFG
drop its dataset makes (``data/datasets.CFGDataset``).
Evaluation sampling, the VAE, FID and multi-card training come with later
slices.

    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_attr_e2e \\
        --workdir toy
    python -m uspace_tpu_torch.cli.train_lfm --config uvit_large \\
        --n_steps 10 --batch 128 --workdir workdir
    python -m uspace_tpu_torch.cli.train_lfm --config unet_large \\
        --n_steps 10 --workdir workdir
    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_unet \\
        --n_steps 3 --device cpu --workdir /tmp/unet
    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_t2i_e2e \\
        --workdir t2i_toy
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..data.datasets import get_dataset
from ..data.loader import DataLoader
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


def device_batch(batch: dict, device: torch.device) -> dict:
    """The step's inputs of a loader batch on ``device``: 'x', and the
    conditioning the mode carries, 'y' (class labels, int64) or 'context'
    (the JAX loop's ``put_batch``: whatever the dataset yields; a
    ``cond`` toy's labels, a ``t2i`` toy's contexts, each with its CFG
    drop)."""
    out = {"x": torch.from_numpy(np.asarray(batch["x"])).to(device)}
    if "y" in batch:
        out["y"] = torch.from_numpy(np.asarray(batch["y"])).long().to(device)
    if "context" in batch:
        out["context"] = torch.from_numpy(np.asarray(batch["context"])).to(
            device)
    return out


def run(config="uvit_large", n_steps: Optional[int] = None,
        batch: Optional[int] = None, seed: Optional[int] = None,
        workdir: str = "workdir", device=None,
        attn_impl: Optional[str] = None, remat_exempt: Optional[int] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train ``n_steps`` (the config's ``train.n_steps`` by default) of
    ``config`` (a config's name or the config itself); returns ``history``
    (per-step loss, grad_norm, lr, nonfinite_skip), the ``checkpoint``
    path, ``model``, ``state``, and the steps' wall ``seconds`` and
    ``img_per_s``. ``batch`` defaults to the config's per-card batch,
    ``seed`` (the init, the data order and the noise) to the config's (0
    where it sets none), ``attn_impl`` to :func:`train_attn_impl`,
    ``remat_exempt`` to the config's (U-ViT)."""
    dev = resolve_device(device)
    cfg = get_config(config)
    tr = cfg["train"]
    seed = cfg.get("seed", 0) if seed is None else seed
    n_steps = tr["n_steps"] if n_steps is None else n_steps
    model = build_train_model(cfg, dev, seed, attn_impl, remat_exempt)
    tx, lr = build_optimizer(cfg)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, sigma_min=cfg["dynamic"]["sigma_min"],
                           ema_rate=tr["ema_rate"], lr_schedule=lr,
                           latents_from_moments=tr["from_moments"])
    batch = batch or tr["batch_size"]
    # the JAX loop's batches for this seed (uspace_tpu/train/loop.py:59-69)
    data = DataLoader(get_dataset(**cfg["dataset"]).get_split("train"),
                      batch, seed=seed,
                      num_workers=cfg.get("dl", {}).get("num_workers", 8)
                      ).infinite()
    every = max(1, tr.get("log_interval", 1))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    history = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        inputs = device_batch(next(data), dev)
        rec = {k: float(v) for k, v in step(state, inputs, gen).items()}
        history.append(rec)
        if i == 0 or (i + 1) % every == 0 or i + 1 == n_steps:
            log(f"step {i + 1}/{n_steps}: loss {rec['loss']:.6f} grad_norm "
                f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e}"
                + (" (non-finite: update skipped)"
                   if rec["nonfinite_skip"] else ""))
    secs = time.perf_counter() - t0
    data.close()
    path = checkpoint.save(os.path.join(workdir, "ckpts"), state)
    img_s = n_steps * batch / secs if secs > 0 else 0.0
    log(f"checkpoint: {path} ({n_steps} steps at batch {batch} in "
        f"{secs:.1f} s, {img_s:.1f} img/s)")
    return dict(history=history, checkpoint=path, model=model, state=state,
                seconds=secs, img_per_s=img_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="uvit_large")
    ap.add_argument("--n_steps", type=int, default=None,
                    help="default: the config's train.n_steps")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the config's per-card batch")
    ap.add_argument("--seed", type=int, default=None,
                    help="default: the config's seed")
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
