"""Shared construction for the dissect CLIs: the frozen evaluation stack
from a config (counterpart of ``uspace_tpu/cli/dissect_common.py``)."""

from __future__ import annotations

import glob
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..codecs.convert import load_reference_nnet
from ..configs import get_config
from ..editing.drivers import DissectSession
from ..train import checkpoint
from .sample_lfm import build_model, build_vae


@torch.no_grad()
def decode_images(vae_decode: Optional[Callable], latents,
                  mini_batch: int) -> np.ndarray:
    """Latents -> [0, 1] images: the VAE's decode in chunks of
    ``mini_batch`` where the session has one, else the first three latent
    channels min-max normalised."""
    if vae_decode is None:
        arr = np.asarray(torch.as_tensor(latents).float().cpu())[..., :3]
        return (arr - arr.min()) / max(arr.max() - arr.min(), 1e-8)
    outs = [vae_decode(latents[i:i + mini_batch]).float().cpu().numpy()
            for i in range(0, len(latents), mini_batch)]
    return np.clip((np.concatenate(outs) + 1) / 2, 0, 1)


def _step(path: str) -> int:
    stem = os.path.splitext(os.path.basename(path))[0]
    return int(stem) if stem.isdigit() else -1


def load_nnet_params(config: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Load the denoiser weights named by ``dissection.ckpt_path_to_dissect``
    into ``model`` (``strict=True``): a checkpoint of this port
    (``<step>.pt`` of ``cli/train_lfm``, its EMA weights; a directory of
    them gives the latest), a reference torch ``nnet[_ema].pth`` or a
    reference ``{step}.ckpt`` directory (its EMA weights first). Without a
    path the model keeps its seeded random weights (smoke mode)."""
    path = config["dissection"].get("ckpt_path_to_dissect") or ""
    if not path:
        print("no ckpt_path_to_dissect: seeded random weights (smoke mode)",
              flush=True)
        return model
    if os.path.isdir(path):
        refs = [os.path.join(path, n) for n in ("nnet_ema.pth", "nnet.pth")
                if os.path.exists(os.path.join(path, n))]
        ckpts = sorted(glob.glob(os.path.join(path, "*.pt")), key=_step)
        if not refs and not ckpts:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = refs[0] if refs else ckpts[-1]
    if path.endswith(".pth"):
        return load_reference_nnet(model, path)
    sd = checkpoint.load(path, map_location=next(model.parameters()).device)
    model.load_state_dict(sd["ema_params"], strict=True)
    return model


def build_session(config, device=None, seed: int = 0,
                  vae_weights: Optional[str] = None
                  ) -> Tuple[DissectSession, Optional[Callable]]:
    """(session, vae_decode or None) from a config (a name or a dict): its
    field in the compute dtype with the dissection's weights (seeded random
    ones without), on ``device`` (CUDA unless "cpu"), and the f32 SD VAE
    when ``vae_weights`` (an ``.npz`` of JAX VAE params, as ``sample_lfm
    --vae_weights``) is given; the session solves with the config's
    ``dissection.solver_kwargs``."""
    cfg = get_config(config)
    dev = resolve_device(device)
    model = load_nnet_params(cfg, build_model(cfg, dev, seed))
    vae_decode = vae_sample = None
    if vae_weights:
        vae = build_vae(cfg, dev, weights=vae_weights)
        vae_decode, vae_sample = vae.decode, vae.sample
    session = DissectSession(model, vae_decode=vae_decode,
                             vae_sample=vae_sample,
                             solver_kwargs=cfg["dissection"]["solver_kwargs"])
    return session, vae_decode
