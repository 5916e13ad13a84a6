"""Sample latents with a config's field, and decode them to pixels.

The sampling branch of ``uspace_tpu/cli/sample_lfm.py`` for the U-ViT
(``uvit_large``) and the SD-UNet (``unet_large``, and ``unet_large_512`` at
64x64 latents): noise goes through ``core.flow.decode`` and each
mini-batch of raw latents ([n, h, w, 4] f32, NHWC: 32x32 at 256 pixels,
64x64 at 512) is written to ``<out>/<first index>.npy``. With ``--decode``
the f32 SD VAE decodes each batch, ``--decode_batch`` latents at a time
(default 10), and the pixels go to ``<out>/<first index>.pixels.npy`` as
uint8 [n, 8h, 8w, 3] (``unpreprocess`` and rounding, as the JAX package's
PNG writer rounds). The chunks bound the decoder's memory: at 512 pixels
one of its [10, 512, 512, 128] f32 activations is 1.3 GB, and its mid
attention over L = 4096 positions holds 64 MB of f32 scores an image.
Without ``--weights`` the field has seeded random weights (the UNet's
zero-initialised output convs drawn small, so that the field is not zero);
``--weights`` takes an ``.npz`` of JAX params keyed ``a/b/c``,
``--vae_weights`` the same for the VAE (seeded weights without it). The
VAE's f32 convolutions run in exact f32, TF32 off. ``--quant`` samples with an int8 view of the same weights,
as the config's ``nnet.quant`` does. The flag alone picks the model's own
view: W8A8 for the U-ViT, the convs only for the SD-UNet. Named views: for
the U-ViT ``w8a8``, ``w8a8_mlp`` and weight-only ``w8`` (the view for
adaptive solves); for the SD-UNet ``conv8``, ``w8a8`` (the convs and the
transformer denses) and ``dense8``. ``--decode`` with ``--quant`` decodes
through the VAE's int8 view (its decoder's 3x3 convs in W8A8).
A conditional config (``train.mode`` ``t2i``, or a labelled dataset)
samples from random test contexts or labels, with classifier-free guidance
at ``--cfg_scale`` (the config's ``sample.cfg_scale``) above 0.
``--attn_impl`` picks the attention route (the JAX package's
``--config.nnet.attn_impl``; default the config's, else ``auto``), e.g.
``pallas_block``, the whole attention sub-block in one kernel, in every
view.

The solve is the config's, fixed-step Euler of ``--steps`` by default.
``--solver adaptive`` runs the reference's eval decode (dopri5 at rtol =
atol = 1e-5 unless ``--rtol`` / ``--atol`` say otherwise; the config's PI
controller unless ``--controller i``); ``--solver fixadp`` is Euler to
``--t_edit`` and adaptive from there. An adaptive solve prints each batch's
field evaluations (NFE), step attempts and accepted steps.
``--field stage_delta_int8`` (the config's ``sample.solver_kwargs.field``,
as in the JAX package) solves with the base-anchored stage-delta int8
field of ``core/delta_field.py`` (adaptive solves of an unconditional
U-ViT only; ``--hidden_mode exact|gelu|grad``, the MLP hidden's cache,
default ``grad``): its int8 codes are fitted once per run on the model's
float weights, whatever ``--quant`` says.

    python -m uspace_tpu_torch.cli.sample_lfm --config unet_large --decode \\
        --n_samples 100 --batch 50 --steps 50 --seed 0 --out samples
    python -m uspace_tpu_torch.cli.sample_lfm --config unet_large_512 \\
        --decode --n_samples 50 --batch 50 --out samples_512
    python -m uspace_tpu_torch.cli.sample_lfm --config unet_large --quant \\
        --decode --n_samples 100 --batch 50 --out samples_int8
    python -m uspace_tpu_torch.cli.sample_lfm --config uvit_large \\
        --n_samples 100 --batch 50 --steps 50 --seed 0 --out samples
    python -m uspace_tpu_torch.cli.sample_lfm --config synthetic_smoke \\
        --quant w8 --solver adaptive --device cpu --n_samples 4 --batch 4 \\
        --out /tmp/w8
    python -m uspace_tpu_torch.cli.sample_lfm --config uvit_t2i_large \\
        --cfg_scale 3 --n_samples 50 --batch 50 --out samples_t2i
    python -m uspace_tpu_torch.cli.sample_lfm --config uvit_large \\
        --solver adaptive --controller i --field stage_delta_int8 \\
        --hidden_mode exact --n_samples 50 --batch 50 --out samples_delta
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..codecs.convert import (
    load_unet_from_jax,
    load_uvit_from_jax,
    load_uvit_t2i_from_jax,
    load_vae_from_jax,
    unflatten,
)
from ..codecs.vae import AutoencoderKL
from ..configs import get_config, solver_kwargs
from ..core import delta_field, flow
from ..data.datasets import get_dataset, unpreprocess
from ..evals.sampling import cfg_velocity_fn, eval_cond, null_cond
from ..models import get_nnet
from ..models.unet import ZERO_INIT_STD
from ..train.step import make_velocity_fn

_LOADERS = {"uvit": load_uvit_from_jax, "uvit_t2i": load_uvit_t2i_from_jax,
            "unet_t2i": load_unet_from_jax}
# --quant: True is each model's own int8 view (W8A8 for the U-ViT, the
# convs for the SD-UNet); the names are those of the models' views
QUANT_CHOICES = ["w8a8", "w8a8_mlp", "w8", "conv8", "dense8"]


def build_model(config: dict, device: torch.device, seed: int = 0,
                weights: Optional[str] = None,
                attn_impl: Optional[str] = None, quant=None):
    """The config's field in its compute dtype, from JAX weights or seeded
    random init (a UNet's zero-initialised output convs drawn live, so that
    the field is not zero). ``attn_impl`` (default: the config's
    ``nnet.attn_impl``, else ``"auto"``) picks the attention route, as
    ``config.nnet.attn_impl`` does in the JAX package. ``quant`` (default:
    the config's ``nnet.quant``) picks a quantized view; such a view keeps
    f32 parameters, on which its int8 scales are fitted, as in the JAX
    package."""
    nnet = dict(config["nnet"])
    name = nnet.pop("name")
    config_impl = nnet.pop("attn_impl", "auto")
    attn_impl = attn_impl or config_impl
    if quant is not None:
        nnet["quant"] = quant
    if nnet.get("quant"):
        nnet["param_dtype"] = torch.float32
    dtype = getattr(torch, config.get("compute_dtype", "float32"))
    model = get_nnet(name, dtype=dtype, attn_impl=attn_impl, device=device,
                     **nnet)
    if weights:
        with np.load(weights) as npz:
            _LOADERS[name](model, unflatten(dict(npz)))
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        if name == "unet_t2i":
            model.init_weights(g, zero_init_std=ZERO_INIT_STD)
        else:
            model.init_weights(g)
    return model.eval()


def build_vae(config: dict, device=None, seed: int = 0,
              weights: Optional[str] = None,
              quant: bool = False) -> AutoencoderKL:
    """The config's f32 SD VAE on ``device`` (CUDA unless "cpu") from JAX
    weights or seeded random init; ``quant``: its int8 decode view. Its f32
    convolutions run in exact f32 on the card, not TF32, as JAX computes on
    the CPU."""
    device = resolve_device(device)
    vae = AutoencoderKL.from_config(config["autoencoder"], quant=quant,
                                    device=device)
    if weights:
        with np.load(weights) as npz:
            load_vae_from_jax(vae, unflatten(dict(npz)))
    else:
        vae.init_weights(torch.Generator(device=device).manual_seed(seed))
    return vae.eval()


def to_uint8(pixels: torch.Tensor) -> np.ndarray:
    """Decoded pixels in [-1, 1] -> uint8 [0, 255] (unpreprocess, then
    rounding)."""
    return np.round(unpreprocess(pixels.float().cpu().numpy()) * 255.0
                    ).astype(np.uint8)


def stage_delta_kwargs(cfg: dict, sk: dict, model,
                       conditioned: bool = False) -> dict:
    """``sk`` without its ``field`` and ``hidden_mode`` keys, and with the
    stage-delta pair when ``field`` asks for it (the JAX sampling layer's
    rule, ``uspace_tpu/train/loop.py:235-299``): adaptive solves of an
    unconditional U-ViT only (``conditioned``: the samples carry labels or
    contexts). The pair's int8 codes are fitted here, once, outside the
    solve."""
    sk = dict(sk)
    field = sk.pop("field", None)
    hidden_mode = sk.pop("hidden_mode", None)
    if field not in (None, "", "stage_delta_int8"):
        raise NotImplementedError(f"solver_kwargs.field={field!r}")
    if not field:
        return sk
    if sk.get("solver", "fixed") != "adaptive":
        raise ValueError(
            "field=stage_delta_int8 needs solver=adaptive: fixed-step solves "
            "should use the plain int8 view (--quant) instead")
    if conditioned or (cfg["nnet"].get("num_classes", -1) or -1) > 0 or \
            float(cfg["sample"].get("cfg_scale", 0.0) or 0.0) > 0:
        raise NotImplementedError("stage_delta_int8 sampling is uncond-only")
    dp = delta_field.prepare_delta_params(model)  # refuses a non-U-ViT
    sk["stage_delta"] = delta_field.make_delta_field(model, dp,
                                                     hidden_mode=hidden_mode)
    return sk


@torch.no_grad()
def run(config="uvit_large", n_samples: int = 100, batch: int = 50,
        steps: int = 50, seed: int = 0, weights: Optional[str] = None,
        out: str = "samples", device=None, quant=None,
        solver: Optional[str] = None, t_edit: Optional[float] = None,
        rtol: Optional[float] = None, atol: Optional[float] = None,
        controller: Optional[str] = None, safety: Optional[float] = None,
        stats: Optional[List[dict]] = None, decode: bool = False,
        vae_weights: Optional[str] = None,
        attn_impl: Optional[str] = None, field: Optional[str] = None,
        hidden_mode: Optional[str] = None,
        decode_batch: int = 10,
        cfg_scale: Optional[float] = None) -> List[str]:
    """Write ceil(n_samples / batch) latent batches, and with ``decode``
    their uint8 pixel batches after each (through the VAE's int8 view when
    ``quant`` is set), ``decode_batch`` latents at a time; returns the
    paths in that order. ``config`` is a config's name or the config
    itself; ``attn_impl`` defaults to its
    ``nnet.attn_impl``, else ``"auto"``. ``field`` and ``hidden_mode``
    (default: the config's ``sample.solver_kwargs``) pick the stage-delta
    field (:func:`stage_delta_kwargs`). For an adaptive solve each batch's
    statistics are printed and, when ``stats`` is a list, appended to it.

    Conditioning follows the config's ``train.mode``, as the JAX loop's
    evaluation does (``uspace_tpu/train/loop.py:224-360``): a ``t2i``
    config samples each batch from the contexts of random test samples, a
    labelled dataset from random labels, both drawn after the batch's
    noise. ``cfg_scale`` (default the config's ``sample.cfg_scale``) above
    0 guides them against the null conditioning (the dataset's empty
    context, the learned null class K) in one forward over the doubled
    batch."""
    dev = resolve_device(device)
    cfg = get_config(config)
    mode = cfg["train"].get("mode", "uncond")
    dataset = get_dataset(**cfg["dataset"])
    conditioned = mode == "t2i" or getattr(dataset, "has_label", False)
    if cfg_scale is None:
        cfg_scale = float(cfg["sample"].get("cfg_scale", 0.0) or 0.0)
    model = build_model(cfg, dev, seed, weights, attn_impl=attn_impl,
                        quant=quant)
    vae = (build_vae(cfg, dev, seed, vae_weights, quant=bool(quant))
           if decode else None)
    sk = solver_kwargs(cfg, steps, solver=solver, rtol=rtol, atol=atol,
                       controller=controller, safety=safety, field=field,
                       hidden_mode=hidden_mode)
    sk = stage_delta_kwargs(cfg, sk, model, conditioned)
    c, h, w = cfg["z_shape"]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    os.makedirs(out, exist_ok=True)
    paths = []
    for b in range(math.ceil(n_samples / batch)):
        n = min(batch, n_samples - b * batch)
        z = torch.randn((n, h, w, c), generator=gen, dtype=torch.float32,
                        device=dev)
        cond = eval_cond(mode, dataset, n, gen, dev)
        if "stage_delta" in sk:
            vf = None
        elif cfg_scale > 0 and cond:
            vf = cfg_velocity_fn(model, cond, null_cond(dataset, cond),
                                 cfg_scale)
        else:
            vf = make_velocity_fn(model, cond)
        st = {}
        lat = flow.decode(vf, z, sk, t_edit=t_edit, stats=st)
        if st:
            print(f"batch {b}: NFE {st['nfe']}, steps {st['steps']}, "
                  f"accepted {st['accepted']}, t {st['t']:.6g}", flush=True)
            if stats is not None:
                stats.append(st)
        path = os.path.join(out, f"{b * batch}.npy")
        np.save(path, lat.float().cpu().numpy())
        paths.append(path)
        if vae is not None:
            path = os.path.join(out, f"{b * batch}.pixels.npy")
            np.save(path, np.concatenate([
                to_uint8(vae.decode(lat[i:i + decode_batch]))
                for i in range(0, n, decode_batch)]))
            paths.append(path)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="uvit_large")
    ap.add_argument("--n_samples", type=int, default=100)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", default=None,
                    help=".npz of JAX field params (keys a/b/c)")
    ap.add_argument("--out", default="samples")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--quant", nargs="?", const=True, default=None,
                    choices=QUANT_CHOICES,
                    help="int8 sampling view (the flag alone: the model's "
                    "own, W8A8 for the U-ViT, the convs for the SD-UNet)")
    ap.add_argument("--solver", default=None,
                    choices=["fixed", "adaptive", "fixadp"],
                    help="default: the config's (fixed-step Euler)")
    ap.add_argument("--t_edit", type=float, default=None,
                    help="split time of --solver fixadp")
    ap.add_argument("--rtol", type=float, default=None)
    ap.add_argument("--atol", type=float, default=None)
    ap.add_argument("--controller", default=None, choices=["i", "pi"])
    ap.add_argument("--safety", type=float, default=None)
    ap.add_argument("--decode", action="store_true",
                    help="decode each batch with the f32 SD VAE (its int8 "
                    "view with --quant) and write uint8 pixels")
    ap.add_argument("--decode_batch", type=int, default=10,
                    help="latents per VAE decode call")
    ap.add_argument("--vae_weights", default=None,
                    help=".npz of JAX VAE params (keys a/b/c)")
    ap.add_argument("--attn_impl", default=None,
                    help="attention route, e.g. pallas_block (default: the "
                    "config's nnet.attn_impl, else auto)")
    ap.add_argument("--field", default=None,
                    help="stage_delta_int8: the base-anchored stage-delta "
                    "int8 field for --solver adaptive (default: the "
                    "config's sample.solver_kwargs.field)")
    ap.add_argument("--cfg_scale", type=float, default=None,
                    help="classifier-free guidance scale for a conditional "
                    "config (default: the config's sample.cfg_scale)")
    ap.add_argument("--hidden_mode", default=None,
                    choices=["exact", "gelu", "grad"],
                    help="the stage-delta field's MLP hidden cache (default: "
                    "the config's sample.solver_kwargs.hidden_mode, else "
                    "grad)")
    a = ap.parse_args(argv)
    paths = run(a.config, a.n_samples, a.batch, a.steps, a.seed, a.weights,
                a.out, a.device, a.quant, a.solver, a.t_edit, a.rtol, a.atol,
                a.controller, a.safety, decode=a.decode,
                vae_weights=a.vae_weights, attn_impl=a.attn_impl,
                field=a.field, hidden_mode=a.hidden_mode,
                decode_batch=a.decode_batch, cfg_scale=a.cfg_scale)
    print(f"wrote {len(paths)} arrays to {a.out}")


if __name__ == "__main__":
    main()
