"""u-space dissection CLI for unconditional and class-conditional models.

Counterpart of ``uspace_tpu/cli/dissect_lfm.py`` (the reference's
``dissect_lfm.py``: read activations, build directions, write / steer).
The flags are named after the config keys the JAX CLI reads
(``--config.dissection.<key>`` there); a flag left out keeps the config's
``dissection`` value. Runs on the card unless ``--device cpu``.

    python -m uspace_tpu_torch.cli.dissect_lfm --config uvit_large \\
        --dissect_name read --n_samples 8 --mini_batch_size 4
    python -m uspace_tpu_torch.cli.dissect_lfm --config uvit_large \\
        --dissect_name build_attr                     # or build_pca
    python -m uspace_tpu_torch.cli.dissect_lfm --config uvit_large \\
        --dissect_name write_attr --ith_attr 0 --write_scales=-100,0,100
    python -m uspace_tpu_torch.cli.dissect_lfm --config uvit_large \\
        --dissect_name vis_reversible
    python -m uspace_tpu_torch.cli.dissect_lfm --config synthetic_smoke \\
        --dissect_name read --device cpu --read_path_root /tmp/dissect

Modes: ``read`` encodes ``n_samples`` of the config's dataset with the
``edit_loc`` tap captured and writes ``<read_path_root>/read.npz``;
``build_attr`` / ``build_pca`` write ``directions_attr.npz`` /
``directions_pca.npz`` beside it; ``write_attr`` / ``write_pca`` decode one
noise batch under each write scale of the chosen direction and
``write_x0`` steers the noise itself, each writing
``<workdir>/<mode>_sweep.png``; ``vis_reversible`` appends the
encode -> decode error of one batch to ``<workdir>/delta_change.txt``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..data.datasets import get_dataset
from ..data.loader import DataLoader
from ..editing.directions import latentz_delta, select_direction
from ..editing.drivers import build_directions_npz
from ..train.step import sample_from_moments
from ..utils.vis import make_grid, save_image
from .dissect_common import build_session, decode_images


def _read_path(d: dict) -> str:
    return os.path.join(d.get("read_path_root") or "dissect/read", "read.npz")


def _directions_path(d: dict, mode: str) -> str:
    return os.path.join(os.path.dirname(_read_path(d)),
                        f"directions_{mode}.npz")


def _ith(v):
    """An attribute or component index: an int, or "31_39_20" to average
    several."""
    return int(v) if isinstance(v, (int, np.integer)) or str(v).isdigit() \
        else str(v)


def run(config, dissect_name: Optional[str] = None,
        workdir: str = "dissect_out", device=None, seed: int = 0,
        vae_weights: Optional[str] = None, **overrides) -> str:
    """One dissection mode of ``config`` (a name or a dict); ``overrides``
    replace keys of its ``dissection`` block (``solver_fix_step`` its
    solve's step). Returns the path of the artifact written."""
    cfg = get_config(config)
    d = cfg["dissection"]
    step = overrides.pop("solver_fix_step", None)
    if step is not None:
        d["solver_kwargs"] = dict(d["solver_kwargs"], solver_fix_step=step)
    d.update({k: v for k, v in overrides.items() if v is not None})
    name = dissect_name or d.get("dissect_name")
    if name in ("build_attr", "build_pca"):  # no model needed
        mode = name.split("_")[1]
        return build_directions_npz(_read_path(d), _directions_path(d, mode),
                                    mode=mode, pca_n=d["pca_n"],
                                    device=device)

    session, vae_decode = build_session(cfg, device, seed, vae_weights)
    dev = session.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    from_moments = cfg["train"].get("from_moments", True)
    os.makedirs(workdir, exist_ok=True)

    def cond(n):
        """Class-conditional models take ``class_label`` in the write and
        roundtrip modes (the read takes the batch's labels)."""
        if (cfg["nnet"].get("num_classes", -1) or -1) > 0:
            y = int(d.get("class_label", 0) or 0)
            return {"y": torch.full((n,), y, dtype=torch.int64, device=dev)}
        return None

    if name == "read":
        data = get_dataset(**cfg["dataset"]).get_split("train")
        loader = DataLoader(data, d["mini_batch_size"], shuffle=False)
        out = session.read(loader, tap=d.get("edit_loc") or "mid",
                           max_samples=d["n_samples"], generator=gen,
                           from_moments=from_moments)
        path = _read_path(d)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **out)
        print(f"read: {len(out['latent'])} samples, feats "
              f"{out['feats'].shape} -> {path}", flush=True)
        return path

    if name in ("write_attr", "write_pca", "write_x0"):
        c, h, w = cfg["z_shape"]
        n = min(d["n_samples"], d["mini_batch_size"])
        fixed_z = None
        if d.get("fixed_z_path"):
            # raw .npy of latents, a read .npz (its 'latent'), or
            # "from_read" for this config's read artifact
            fz = _read_path(d) if d["fixed_z_path"] == "from_read" \
                else d["fixed_z_path"]
            loaded = np.load(fz)
            if hasattr(loaded, "files"):
                loaded = loaded["latent"]
            fixed_z = torch.as_tensor(loaded, device=dev)
        if name == "write_x0":
            # z-space steering: z + scale * delta_z, then a plain decode
            with np.load(_read_path(d)) as data:
                delta_z = latentz_delta(torch.as_tensor(data["latent"]),
                                        torch.as_tensor(data["attr"]))
            delta = select_direction(delta_z[None], _ith(d["ith_attr"]))[0]
            z = (fixed_z[:n] if fixed_z is not None else torch.randn(
                (n, h, w, c), generator=gen, device=dev))
            sweep = torch.stack([session.decode(
                z + float(s) * delta[None].to(dev), cond=cond(n))
                for s in d["write_scales"]])
        else:
            mode = name.split("_")[1]
            with np.load(_directions_path(d, mode)) as dirs:
                grid_all = torch.as_tensor(dirs["directions"])
                t_grid = dirs["t_grid"]
            # the grid's spacing comes from the read, not from the solver
            grid_t0 = float(t_grid[0]) if len(t_grid) else 0.0
            grid_dt = (float(t_grid[1] - t_grid[0]) if len(t_grid) > 1
                       else None)
            ith = d["ith_attr"] if mode == "attr" else d["ith_component"]
            every = str(d["t_edit"]).startswith("every_")
            sweep = session.write_sweep(
                select_direction(grid_all, _ith(ith)), list(d["write_scales"]),
                n, grid_dt=grid_dt, grid_t0=grid_t0,
                loc=d.get("edit_loc") or "mid",
                t_edit=1.0 if every else float(d["t_edit"]),
                gate_mode="every" if every else "le",
                gate_period=(float(str(d["t_edit"])[len("every_"):])
                             if every else 0.1),
                fixed_z=fixed_z, generator=gen, z_shape=(h, w, c),
                cond=cond(n))
        s, b = sweep.shape[:2]
        imgs = decode_images(vae_decode,
                             sweep.reshape(s * b, *sweep.shape[2:]),
                             d["mini_batch_size"])
        path = os.path.join(workdir, f"{name}_sweep.png")
        save_image(make_grid(imgs, nrow=b), path)
        print(f"write sweep ({s} scales x {b} samples) -> {path}", flush=True)
        return path

    if name in ("vis_reversible", "eval_vf_interp"):
        data = get_dataset(**cfg["dataset"]).get_split("train")
        batch = next(iter(DataLoader(data, d["mini_batch_size"],
                                         shuffle=False)))
        x = torch.as_tensor(batch["x"], device=dev)
        if from_moments:
            x = (session.vae_sample(x, gen) if session.vae_sample
                 else sample_from_moments(x, gen))
        errs = session.roundtrip_error(x, cond=cond(x.shape[0]))
        line = (f"solver={d['solver_kwargs']} abs_mean={errs['abs_mean']:.6f}"
                f" rel_mean={errs['rel_mean']:.6f}")
        print(f"roundtrip: {line}", flush=True)
        path = os.path.join(workdir, "delta_change.txt")
        with open(path, "a") as f:  # appended, as the reference's
            f.write(line + "\n")
        return path

    raise NotImplementedError(f"dissect_name={name!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--dissect_name", required=True,
                    choices=["read", "build_attr", "build_pca", "write_attr",
                             "write_pca", "write_x0", "vis_reversible",
                             "eval_vf_interp"])
    ap.add_argument("--workdir", default="dissect_out")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vae_weights", default=None,
                    help=".npz of JAX VAE params: decode sweeps to pixels "
                    "and draw read latents through the VAE")
    ap.add_argument("--n_samples", type=int, default=None)
    ap.add_argument("--mini_batch_size", type=int, default=None)
    ap.add_argument("--ckpt_path_to_dissect", default=None)
    ap.add_argument("--fixed_z_path", default=None)
    ap.add_argument("--read_path_root", default=None)
    ap.add_argument("--write_scales", default=None,
                    help="comma-separated, e.g. -100,0,100")
    ap.add_argument("--ith_component", default=None)
    ap.add_argument("--ith_attr", default=None,
                    help='an index, or e.g. "31_39_20" to average several')
    ap.add_argument("--pca_n", type=int, default=None)
    ap.add_argument("--class_label", type=int, default=None)
    ap.add_argument("--t_edit", default=None,
                    help='a time, or "every_<period>"')
    ap.add_argument("--edit_loc", default=None,
                    choices=["head", "mid", "tail"])
    ap.add_argument("--solver_fix_step", type=float, default=None)
    a = vars(ap.parse_args(argv))
    if a["write_scales"] is not None:
        a["write_scales"] = tuple(float(v) for v in
                                  a["write_scales"].split(","))
    print(run(a.pop("config"), a.pop("dissect_name"), **a))


if __name__ == "__main__":
    main()
