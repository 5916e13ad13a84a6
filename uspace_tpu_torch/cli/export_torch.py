"""Export a trained checkpoint of this port in the reference's torch
format (counterpart of ``uspace_tpu/cli/export_torch.py``):

    python -m uspace_tpu_torch.cli.export_torch \\
        --ckpt workdir/<config>/default/ckpts --out nnet_ema.pth [--raw]

The EMA weights of the latest checkpoint (or of ``--step``; ``--raw``: the
trained weights) are written as a plain state dict of CPU f32 tensors. The
port's modules carry the reference's names, so the file loads into the
reference's U-ViT / U-ViT-T2I / SD-UNet, and into a fresh model of this
port, with ``strict=True``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from ..train.checkpoint import CheckpointManager


def export(ckpt: str, out: str, ema: bool = True,
           step: Optional[int] = None) -> int:
    """Write the (EMA) weights of ``ckpt`` (a ckpts directory, or one
    ``<step>.pt`` file) to ``out``; returns the number of tensors."""
    if os.path.isfile(ckpt):
        root, name = os.path.split(ckpt)
        step = int(os.path.splitext(name)[0])
        ckpt = root
    sd = CheckpointManager(ckpt).restore_params(step, ema=ema,
                                                map_location="cpu")
    sd = {k: v.float().contiguous() for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(sd, out)
    return len(sd)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="a ckpts directory or a <step>.pt file")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--step", type=int, default=None,
                    help="default: the latest")
    ap.add_argument("--raw", action="store_true",
                    help="export the trained weights, not the EMA")
    a = ap.parse_args(argv)
    n = export(a.ckpt, a.out, ema=not a.raw, step=a.step)
    print(f"exported {n} tensors -> {a.out}", flush=True)


if __name__ == "__main__":
    main()
