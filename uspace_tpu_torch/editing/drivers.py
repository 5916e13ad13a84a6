"""Dissection drivers: the read / direction-build / write / roundtrip flows.

Counterpart of ``uspace_tpu/editing/drivers.py``. The reference's dissect
entry points dump activations per ODE step and re-read them; here the read
keeps its capture grids in memory and writes one ``.npz`` per phase.

- read: latents -> exact inversion with activation capture -> (latents,
  attrs, activation grid);
- directions: attribute deltas or per-time PCA over the read artifact;
- write sweep: decode the same noise under each write scale ->
  [S, B, ...] latents;
- roundtrip: encode -> decode reconstruction error.

Every flow carries its conditioning (class labels or text contexts) through
the read, the decode and the write; a T2I decode also takes a
prompt-to-prompt ``AttnEdit``, the encode never does.

PyTorch runs eagerly, so the JAX package's one compiled program per call
structure is one eager call here, and the write sweep decodes one scale
after the other, as the JAX sweep does.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import flow
from ..train.step import make_velocity_fn, sample_from_moments
from .capture import capture_trajectory, captures_to_grid
from .directions import attr_delta_directions, pca_directions
from .specs import AttnEdit, USpaceEdit

DEFAULT_SOLVER_KWARGS = {"solver": "fixed", "solver_fix": "euler",
                         "solver_fix_step": 0.01}


class DissectSession:
    """A frozen evaluation stack: the denoiser (its weights inside) and
    optionally the VAE's decode and sample, with the encode, decode and
    capture primitives that the flows compose."""

    def __init__(self, model: torch.nn.Module,
                 vae_decode: Optional[Callable] = None,
                 vae_sample: Optional[Callable] = None,
                 solver_kwargs: Optional[dict] = None):
        self.model = model
        self.vae_decode = vae_decode
        self.vae_sample = vae_sample
        self.solver_kwargs = dict(solver_kwargs or DEFAULT_SOLVER_KWARGS)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- primitives ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, x: torch.Tensor, cond: Optional[Dict] = None,
               attn_edit: Optional[AttnEdit] = None) -> torch.Tensor:
        """Exact inversion x -> z (fixed-step, t: 1 -> 0) with the
        conditioning ``cond`` ('y' or 'context'). An attention edit is never
        applied here: the reference edits only while decoding
        (``tools/utils_t2i.py:276-278``), so ``attn_edit`` is ignored."""
        vf = make_velocity_fn(self.model, cond)
        return flow.encode(vf, x, self.solver_kwargs)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, cond: Optional[Dict] = None,
               edit: Optional[USpaceEdit] = None,
               attn_edit: Optional[AttnEdit] = None,
               t_edit: Optional[float] = None,
               stats: Optional[dict] = None) -> torch.Tensor:
        """z -> x (t: 0 -> 1) with the conditioning ``cond``, under an
        optional write edit and an optional prompt-to-prompt attention edit
        (T2I); ``t_edit`` is the split time of the "fixadp" solver; a dict
        passed as ``stats`` receives an adaptive solve's step and
        evaluation counts."""
        kw = {} if edit is None else {"edit": edit}
        if attn_edit is not None:
            kw["attn_edit"] = attn_edit
        vf = make_velocity_fn(self.model, cond, **kw)
        return flow.decode(vf, z, self.solver_kwargs, t_edit=t_edit,
                           stats=stats)

    # -- read phase -----------------------------------------------------------

    def num_grid_steps(self) -> int:
        step = self.solver_kwargs.get("solver_fix_step", 0.01)
        return max(1, round(1.0 / step))

    def read(self, batches: Iterable[Dict[str, Any]], tap: str = "mid",
             from_moments: bool = True,
             generator: Optional[torch.Generator] = None,
             max_samples: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Encode data while capturing ``tap``'s activations.

        ``batches``: dicts with 'x' (moments, or latents when
        ``from_moments`` is False) and optionally 'attr', 'y', 'context'.
        Latents are drawn from moments with ``generator``'s noise (the VAE's
        sample where the session has one), one batch after the other.
        Returns ``{'latent': [N, ...], 'feats': [N, T, ...], 't_grid': [T],
        'attr': [N, A]}`` in f32 numpy ('attr' when the batches carry
        it)."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        lat, attrs, feats = [], [], []
        t_grid = None
        n_seen = 0
        for batch in batches:
            x = torch.as_tensor(np.asarray(batch["x"]), device=dev)
            if from_moments:
                x = (self.vae_sample(x, generator) if self.vae_sample
                     else sample_from_moments(x, generator))
            cond = {k: torch.as_tensor(np.asarray(batch[k]), device=dev)
                    for k in ("y", "context") if k in batch}
            z, stacks = capture_trajectory(
                self.model, x, cond=cond, taps=(tap,), direction="encode",
                num_steps=self.num_grid_steps(),
                method=self.solver_kwargs.get("solver_fix", "euler"))
            grid = captures_to_grid(stacks[tap], stacks["t"])
            if t_grid is None:
                t_grid = np.sort(stacks["t"].numpy())
            lat.append(z.float().cpu().numpy())
            feats.append(grid.float().cpu().numpy().swapaxes(0, 1))
            if "attr" in batch:
                attrs.append(np.asarray(batch["attr"]))
            n_seen += x.shape[0]
            if max_samples and n_seen >= max_samples:
                break
        out = {"latent": np.concatenate(lat).astype(np.float32),
               "feats": np.concatenate(feats).astype(np.float32),
               "t_grid": np.asarray(t_grid, np.float32)}
        if attrs:
            out["attr"] = np.concatenate(attrs)
        return out

    # -- write phase ----------------------------------------------------------

    @torch.no_grad()
    def write_sweep(
        self,
        delta_grid: torch.Tensor,
        write_scales: Sequence[float],
        n_samples: int,
        *,
        loc: str = "mid",
        t_edit: float = 1.0,
        gate_mode: str = "le",
        gate_period: float = 0.1,
        grid_dt: Optional[float] = None,
        grid_t0: float = 0.0,
        cond: Optional[Dict] = None,
        fixed_z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        z_shape: Tuple[int, ...] = (32, 32, 4),
        stats: Optional[list] = None,
    ) -> torch.Tensor:
        """Decode the same noise under each write scale -> [S, B, ...]
        latents, one scale after the other. A list passed as ``stats``
        receives each scale's adaptive solve statistics.

        ``grid_dt`` is the delta grid's time spacing (the read artifact's
        ``t_grid``); without it the session's ``solver_fix_step`` stands in,
        which is right only when this session made the read. A session
        without one (an adaptive solver) refuses, rather than move the edit
        to the wrong times."""
        dev = self.device
        if fixed_z is not None:
            z = torch.as_tensor(fixed_z, device=dev)[:n_samples]
        else:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            z = torch.randn((n_samples, *z_shape), generator=generator,
                            device=dev)
        gd = grid_dt or self.solver_kwargs.get("solver_fix_step")
        if gd is None:
            raise ValueError(
                "write_sweep needs grid_dt: this session has no "
                "solver_fix_step to infer it from (adaptive solver), and "
                "a wrong spacing silently rescales the edit forcing in "
                "time. Pass the read artifact's t_grid spacing.")
        edit0 = USpaceEdit(
            delta_grid=torch.as_tensor(delta_grid, dtype=torch.float32,
                                       device=dev),
            scale=0.0, grid_dt=gd, grid_t0=grid_t0, t_edit=t_edit,
            gate_mode=gate_mode, gate_period=gate_period, loc=loc)
        # t_edit doubles as the fixadp split point (fixed steps while the
        # edit is active, adaptive after); fixed and adaptive solves
        # ignore it
        out = []
        for s in write_scales:
            st = {}
            out.append(self.decode(z, cond, edit=edit0.replace(scale=float(s)),
                                   t_edit=t_edit, stats=st))
            if stats is not None:
                stats.append(st)
        return torch.stack(out)

    # -- correctness probes ---------------------------------------------------

    @torch.no_grad()
    def roundtrip_error(self, x: torch.Tensor,
                        cond: Optional[Dict] = None) -> Dict[str, float]:
        """encode -> decode reconstruction error (the reference's
        vis_reversible / cal_delta_change probe)."""
        rec = self.decode(self.encode(x, cond), cond)
        err = (rec - x).abs()
        rel = torch.linalg.norm((rec - x).reshape(x.shape[0], -1), dim=1) / (
            torch.linalg.norm(x.reshape(x.shape[0], -1), dim=1) + 1e-12)
        return {"abs_max": float(err.max()), "abs_mean": float(err.mean()),
                "rel_mean": float(rel.mean())}


def build_directions_npz(read_npz: str, out_path: str, mode: str = "attr",
                         pca_n: int = 50, device=None) -> str:
    """Direction building over a read artifact, on ``device`` (CUDA unless
    "cpu"): ``mode="attr"`` the attribute deltas, ``"pca"`` the first
    ``pca_n`` components per time. Writes ``directions`` [T, A|K, ...],
    ``t_grid`` and ``mode``."""
    dev = resolve_device(device)
    with np.load(read_npz) as data:
        feats = torch.as_tensor(data["feats"], device=dev)  # [N, T, ...]
        t_grid = data["t_grid"]
        if mode == "attr":
            if "attr" not in data:
                raise ValueError(f"{read_npz} has no attrs; read with a "
                                 "dataset that carries them")
            grid = attr_delta_directions(
                feats, torch.as_tensor(data["attr"], device=dev))
        elif mode == "pca":
            grid = pca_directions(feats, pca_n)
        else:
            raise ValueError(f"unknown direction mode {mode!r}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, directions=grid.cpu().numpy(), t_grid=t_grid,
             mode=mode)
    print(f"directions ({mode}) {tuple(grid.shape)} -> {out_path}",
          flush=True)
    return out_path
