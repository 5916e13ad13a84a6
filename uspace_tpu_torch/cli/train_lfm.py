"""Train a U-ViT or SD-UNet velocity field with OT-CFM on a config's
dataset: the training experiment of ``uspace_tpu/cli/train_lfm.py``.

``main`` runs ``train/loop.train`` (resume from the latest checkpoint,
metrics, sample grids, checkpoints, in-loop FID with best-checkpoint
selection, graceful SIGTERM) in JAX's workdir layout
``<workdir>/<config>/<hparams from the overrides>`` (``default`` without
overrides). Overrides take JAX's form, ``--config.train.batch_size=64``
(values read as Python literals); ``--n_steps``, ``--batch``, ``--seed``,
``--attn_impl`` and ``--remat_exempt`` are the overrides of
``train.n_steps``, ``train.batch_size``, ``seed``, ``nnet.attn_impl`` and
``nnet.remat_exempt``. ``train.batch_size`` is the per-process batch.
Under ``torchrun --nproc_per_node N`` each process joins one process group
(``parallel/distributed.initialize``) and trains data-parallel.

:func:`run` is the same loop for a caller that wants the run's
history (per-step loss, grad_norm, lr, nonfinite_skip) and its final
checkpoint ``<workdir>/ckpts/<n_steps>.pt`` (its EMA weights are what
``cli/dissect_common.load_nnet_params`` loads), with
``n_steps`` and ``batch`` given apart from the config. The attention route
follows the JAX loop's rule (:func:`train_attn_impl`): the U-ViT trains on
``"pallas_packed"`` (XLA projection, packed attention kernel and its
backward kernel) with per-block remat, the SD-UNet on its own ``"auto"``;
a config whose ``nnet.attn_impl`` is ``"pallas_block"`` trains the U-ViT
through the whole attention sub-block kernel and its recompute backward.
One loop serves every mode: the batches' class labels (``cond``) or text
contexts (``t2i``) reach the field as the JAX step passes them, each with
the CFG drop its dataset makes.

    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_smoke \\
        --device cpu --workdir /tmp/runs
    python -m uspace_tpu_torch.cli.train_lfm --config uvit_large \\
        --config.train.n_steps=10 --workdir workdir
    torchrun --nproc_per_node 4 -m uspace_tpu_torch.cli.train_lfm \\
        --config uvit_large --workdir workdir
    python -m uspace_tpu_torch.cli.train_lfm --config synthetic_attr_e2e \\
        --workdir toy
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Callable, List, Optional

from .. import resolve_device
from ..configs import get_config
from ..parallel import distributed
from ..train import checkpoint  # noqa: F401  (train_lfm.checkpoint.load)
# the helpers' callers import them from here
from ..train.loop import (  # noqa: F401
    Experiment,
    build_optimizer,
    build_train_model,
    device_batch,
    fit,
    train,
    train_attn_impl,
)
from ..train.step import make_train_step


def run(config="uvit_large", n_steps: Optional[int] = None,
        batch: Optional[int] = None, seed: Optional[int] = None,
        workdir: str = "workdir", device=None,
        attn_impl: Optional[str] = None, remat_exempt: Optional[int] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train ``config`` (a config's name or the config itself) in
    ``workdir`` through ``train/loop.fit`` to step ``n_steps`` (the
    config's ``train.n_steps`` by default; the LR schedule keeps the
    config's), resuming from ``workdir``'s latest checkpoint (a checkpoint
    at or past ``n_steps`` is refused: ValueError); returns
    ``history`` (per-step loss, grad_norm, lr, nonfinite_skip), the final
    ``checkpoint`` path, ``model``, ``state``, and the steps' wall
    ``seconds`` and ``img_per_s``. ``batch`` defaults to the config's
    per-card batch, ``seed`` (the init, the data order and the noise) to
    the config's (0 where it sets none), ``attn_impl`` to
    :func:`train_attn_impl`, ``remat_exempt`` to the config's (U-ViT)."""
    dev = resolve_device(device)
    cfg = get_config(config)
    if seed is not None:
        cfg["seed"] = seed
    if batch:
        cfg["train"]["batch_size"] = batch
    exp = Experiment(cfg, workdir, device=dev, attn_impl=attn_impl,
                     remat_exempt=remat_exempt, make_step=make_train_step)
    n_steps = cfg["train"]["n_steps"] if n_steps is None else n_steps
    done = exp.ckpt.latest_step()
    if done is not None and done >= n_steps:
        raise ValueError(f"{exp.ckpt.ckpt_root} already holds step {done}, "
                         f"at or past n_steps {n_steps}: no step would run")
    history: List[dict] = []
    out = fit(exp, n_steps, log=log, history=history)
    secs = out["seconds"]
    img_s = len(history) * exp.global_batch / secs if secs > 0 else 0.0
    log(f"checkpoint: {out['checkpoint']} ({len(history)} steps at batch "
        f"{exp.global_batch} in {secs:.1f} s, {img_s:.1f} img/s)")
    return dict(history=history, checkpoint=out["checkpoint"],
                model=exp.train_model, state=out["state"], seconds=secs,
                img_per_s=img_s)


# the flags that stand for config overrides
_ALIASES = {"n_steps": "train.n_steps", "batch": "train.batch_size",
            "seed": "seed", "attn_impl": "nnet.attn_impl",
            "remat_exempt": "nnet.remat_exempt"}


def hparams_from_argv(argv) -> str:
    """Experiment identity string from CLI overrides
    (reference train_lfm.py:355-371)."""
    parts = []
    for a in argv:
        if a.startswith("--config.") and "=" in a:
            k, v = a[len("--config."):].split("=", 1)
            parts.append(f"{k.split('.')[-1]}={v}")
    return "-".join(parts) or "default"


def apply_override(cfg: dict, override: str) -> None:
    """``--config.a.b=v``: set ``cfg["a"]["b"]`` to ``v`` read as a Python
    literal (a string where it is none)."""
    key, value = override[len("--config."):].split("=", 1)
    try:
        value = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    *parents, leaf = key.split(".")
    node = cfg
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = value


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="uvit_large")
    ap.add_argument("--workdir", default="workdir",
                    help="runs go to <workdir>/<config>/<hparams>")
    ap.add_argument("--device", default=None, help="default: cuda")
    for flag, key in _ALIASES.items():
        ap.add_argument(f"--{flag}", default=None,
                        help=f"--config.{key}=...")
    a, rest = ap.parse_known_args(argv)
    overrides = [f"--config.{key}={getattr(a, flag)}"
                 for flag, key in _ALIASES.items()
                 if getattr(a, flag) is not None]
    for r in rest:
        if not (r.startswith("--config.") and "=" in r):
            ap.error(f"unrecognized argument {r}")
        overrides.append(r)
    distributed.initialize()  # no-op on a single process
    cfg = get_config(a.config)
    for o in overrides:
        apply_override(cfg, o)
    workdir = os.path.join(a.workdir, a.config, hparams_from_argv(overrides))
    train(cfg, workdir, device=a.device)


if __name__ == "__main__":
    main()
