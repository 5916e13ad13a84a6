"""The training experiment: one loop for every mode, driven by a config
(counterpart of ``uspace_tpu/train/loop.py``).

:class:`Experiment` builds what a run needs from a config: the dataset and
its process-sharded loader, the field twice over the same weights (the
training view on :func:`train_attn_impl`'s route; the sampling view on the
config's route, else ``"auto"``, loaded with the EMA weights for each
evaluation), the optimizer, the state with its draw generator, the
checkpoint manager, the reference VAE and the FID featurizer.
:func:`train` runs it: resume from the latest checkpoint, metrics every
``train.log_interval`` steps, a sample grid every ``train.eval_interval``,
a checkpoint and an FID every ``train.save_interval`` (process 0), a stop
at the next step boundary on SIGTERM with one checkpoint, then the final
save, the best checkpoint by FID (``best_ckpt.txt``) and the final FID at
``sample.n_samples`` on it, and a profile of steps start + 10 to start + 13
where ``train.profile_dir`` names a directory.

Data parallelism: one process per card under ``torch.distributed``
(``parallel/distributed``, started by torchrun). ``train.batch_size`` is
the per-process batch: the global batch is ``batch_size`` times the number
of processes (the JAX package reads it as the global batch; the port's
configs carry the reference's per-card batch). Process 0 alone writes
metrics, grids, evaluation directories, checkpoints and ``best_ckpt.txt``.

Exact resume: the train step draws from one sequential generator (seeded
``seed + 1``), whose state the checkpoint holds beside the weights, and the
loader fast-forwards to the resume step, so an interrupted and resumed run
consumes the batches and draws of an uninterrupted one. The grid's and the
FID's draws are seeded from ``(seed, 2 + step)`` and ``(seed, 3 + step)``,
as in the JAX package.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core import flow
from ..data.datasets import get_dataset, unpreprocess
from ..data.loader import DataLoader
from ..evals.sampling import cfg_velocity_fn, eval_cond, null_cond, sample2dir
from ..models import get_nnet
from ..parallel import distributed
from ..utils.logging_utils import (
    MetricsWriter,
    close_log_file,
    dct2str,
    logger,
    set_logger,
)
from ..utils.profiling import start_trace, stop_trace
from ..utils.vis import make_grid, save_image
from .checkpoint import CheckpointManager, load_pretrained_nnet, try_resume
from .preemption import GracefulShutdown
from .state import TrainState, get_lr_schedule, get_optimizer
from .step import make_train_step, make_velocity_fn


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


def seeded(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, stream)`` (the JAX
    loop's ``fold_in(PRNGKey(seed), stream)``)."""
    s = int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class Experiment:
    """Builds the model views, optimizer, state, loader and checkpoint
    manager from a config (a name or a dict). ``device`` defaults to
    CUDA; ``attn_impl`` and ``remat_exempt`` override the training view's
    route and remat rule, ``make_step`` the train-step factory."""

    def __init__(self, config, workdir: Optional[str] = None, *,
                 device=None, attn_impl: Optional[str] = None,
                 remat_exempt: Optional[int] = None,
                 make_step: Callable = make_train_step):
        self.config = cfg = get_config(config)
        self.device = dev = resolve_device(device)
        self.workdir = workdir or os.path.join(cfg.get("workdir", "workdir"),
                                               "default")
        os.makedirs(self.workdir, exist_ok=True)
        self.rank = distributed.process_index()
        self.world = distributed.process_count()

        p = cfg["parallel"]
        if p.get("fsdp", 1) != 1 or p.get("tp", 1) != 1:
            raise NotImplementedError(
                f"parallel.fsdp={p.get('fsdp')} tp={p.get('tp')}: FSDP and "
                "tensor parallelism are not ported; train data-parallel "
                "(fsdp = tp = 1)")
        if p.get("dp", -1) not in (-1, None, self.world):
            raise ValueError(f"parallel.dp={p['dp']} but {self.world} "
                             "processes: dp is the process count (-1)")

        self.seed = cfg.get("seed", 0)
        self.dataset = get_dataset(**cfg["dataset"])
        self.local_batch = cfg["train"]["batch_size"]
        self.global_batch = self.local_batch * self.world
        self.loader = DataLoader(
            self.dataset.get_split("train"), self.local_batch, seed=self.seed,
            num_workers=cfg["dl"]["num_workers"], process_index=self.rank,
            process_count=self.world)

        self.train_model = build_train_model(cfg, dev, self.seed, attn_impl,
                                             remat_exempt)
        path = cfg.get("pretrained_path")
        if path:
            if os.path.exists(path):
                logger.info("loading pretrained nnet from %s", path)
                load_pretrained_nnet(path, self.train_model,
                                     surgery=cfg.get("pretrained_surgery"))
            else:
                logger.warning("pretrained_path %s missing; fresh init", path)
        self.tx, self.lr_schedule = build_optimizer(cfg)
        self.state = TrainState.create(
            dict(self.train_model.named_parameters()), self.tx,
            rng=torch.Generator(device=dev).manual_seed(self.seed + 1))
        self.ckpt = CheckpointManager(os.path.join(self.workdir, "ckpts"))
        self._make_step = make_step
        self._train_step = None
        self._model = None
        self._vae = None
        self._featurizers: Dict[Optional[str], Any] = {}
        # each FID evaluation's seconds: sampling, VAE decode, PNG writing,
        # Inception (reading the PNGs included), Frechet
        self.eval_seconds: List[dict] = []

    # --- the train step --------------------------------------------------

    def train_step_fn(self) -> Callable:
        if self._train_step is None:
            cfg, tr = self.config, self.config["train"]
            self._train_step = self._make_step(
                self.train_model, self.tx,
                sigma_min=cfg["dynamic"]["sigma_min"],
                ema_rate=tr.get("ema_rate", 0.9999),
                lr_schedule=self.lr_schedule,
                latents_from_moments=tr.get("from_moments", True),
                vae_scale=cfg["autoencoder"].get("scale_factor", 0.18215),
                skip_nonfinite=tr.get("skip_nonfinite", True))
        return self._train_step

    # --- the sampling view and the codecs --------------------------------

    def sample_model(self, params: Dict[str, torch.Tensor]
                     ) -> torch.nn.Module:
        """The sampling view (the config's route, else ``"auto"``; its
        compute dtype) holding ``params`` (e.g. the EMA weights)."""
        if self._model is None:
            from ..cli.sample_lfm import build_model

            self._model = build_model(self.config, self.device, self.seed)
        self._model.load_state_dict(params, strict=True)
        return self._model

    def vae(self):
        """The reference VAE's decode where ``autoencoder.pretrained_path``
        exists (``autoencoder_kl.pth``, loaded strictly), else False."""
        if self._vae is None:
            from ..codecs.vae import AutoencoderKL

            block = self.config["autoencoder"]
            path = block.get("pretrained_path", "")
            if path and os.path.exists(path):
                self._vae = AutoencoderKL.from_reference(
                    path, block, self.device).decode
            else:
                self._vae = False
        return self._vae

    def featurizer(self, weights_path: Optional[str]):
        """The FID featurizer for ``weights_path`` (pytorch-fid's file by
        default, "random" for seeded weights), built once."""
        if weights_path not in self._featurizers:
            from ..evals.fid import InceptionFeaturizer

            self._featurizers[weights_path] = InceptionFeaturizer(
                weights_path, self.device)
        return self._featurizers[weights_path]

    # --- sampling ----------------------------------------------------------

    def solver_kwargs(self, sample_steps: Optional[int] = None) -> Dict:
        """The evaluation solve, ``sample.solver_kwargs`` (fixed-step Euler
        by default); a fixed solve's non-positive ``solver_fix_step``
        becomes 1 / ``sample_steps`` (the config's by default)."""
        steps = sample_steps or self.config["sample"]["sample_steps"]
        sk = dict(self.config["sample"].get(
            "solver_kwargs", {"solver": "fixed", "solver_fix": "euler",
                              "solver_fix_step": -1.0}))
        if sk.get("solver", "fixed") == "fixed" and \
                float(sk.get("solver_fix_step", -1.0) or -1.0) <= 0:
            sk["solver_fix_step"] = 1.0 / steps
        return sk

    @torch.no_grad()
    def sample_latents(self, params: Dict[str, torch.Tensor],
                       generator: torch.Generator, n: int,
                       cond: Optional[Dict] = None,
                       sample_steps: Optional[int] = None) -> torch.Tensor:
        """``n`` latents [n, h, w, c] from noise drawn from ``generator``
        with the weights ``params``, the config's solve and, under
        ``sample.cfg_scale`` > 0 with conditioning, classifier-free
        guidance. ``sample.solver_kwargs.field = "stage_delta_int8"`` (with
        ``hidden_mode``) solves with the base-anchored stage-delta int8
        field: adaptive solves of an unconditional U-ViT only, refused
        otherwise (ValueError for a fixed solve, NotImplementedError with
        conditioning or another model). The solve is host-driven, so the
        JAX package's ``driver`` and ``program`` keys select nothing
        here."""
        from ..cli.sample_lfm import stage_delta_kwargs

        c, h, w = self.config["z_shape"]
        model = self.sample_model(params)
        z = torch.randn((n, h, w, c), generator=generator,
                        device=self.device)
        cfg_scale = float(self.config["sample"].get("cfg_scale", 0.0) or 0.0)
        cond = cond or {}
        sk = self.solver_kwargs(sample_steps)
        sk.pop("driver", None)
        sk.pop("program", None)
        use_cfg = cfg_scale > 0 and bool(cond)
        sk = stage_delta_kwargs(self.config, sk, model,
                                conditioned=bool(cond))
        vf = (cfg_velocity_fn(model, cond, self.null_cond(cond), cfg_scale)
              if use_cfg else make_velocity_fn(model, cond))
        return flow.decode(vf, z, sk)

    def null_cond(self, cond: Dict[str, Any]) -> Dict[str, Any]:
        """Null conditioning for CFG (``evals/sampling.null_cond``)."""
        return null_cond(self.dataset, cond)

    def eval_cond(self, generator: torch.Generator, n: int
                  ) -> Dict[str, Any]:
        """Conditioning for evaluation sampling, by mode
        (``evals/sampling.eval_cond``)."""
        return eval_cond(self.config["train"]["mode"], self.dataset, n,
                         generator, self.device)


def train(config, workdir: Optional[str] = None, device=None
          ) -> TrainState:
    """Run the config's experiment in ``workdir`` (resuming from its
    latest checkpoint) and return the final state."""
    return fit(Experiment(config, workdir, device=device))["state"]


def fit(exp: Experiment, n_steps: Optional[int] = None,
        log: Optional[Callable[[str], None]] = None,
        history: Optional[List[dict]] = None) -> dict:
    """The loop of :func:`train` on a built experiment, to step
    ``n_steps`` (the config's ``train.n_steps`` by default). ``log`` takes
    the step lines (step 1, every ``train.log_interval`` and the last; the
    package logger by default); ``history``, a list, receives every step's
    metrics as floats. Returns ``state``, ``step``, ``preempted``, the
    last ``checkpoint`` path and the steps' wall ``seconds``."""
    cfg = exp.config
    n_steps = cfg["train"]["n_steps"] if n_steps is None else n_steps
    is_main = exp.rank == 0
    log_file = os.path.join(exp.workdir, "train.log") if is_main else None
    set_logger("info", log_file)
    log = log or logger.info
    # an optional experiment tracker (reference train_lfm.py:44-52 inits
    # wandb on the main process): config tracker = {name: "wandb",
    # project, run_name, mode}; metrics always land in metrics.jsonl too
    tracker = dict(cfg.get("tracker") or {})
    use_wandb = is_main and tracker.get("name") == "wandb"
    metrics_w = MetricsWriter(
        os.path.join(exp.workdir, "metrics.jsonl") if is_main else None,
        use_wandb=use_wandb,
        wandb_kwargs=dict(project=tracker.get("project", "lfm_uvit"),
                          name=tracker.get("run_name") or None,
                          mode=tracker.get("mode", "online"),
                          config=cfg) if use_wandb else None)
    try:
        state = try_resume(exp.ckpt, exp.state)
        start_step = int(state.step)
        if start_step:
            log(f"resumed at step {start_step}")
        # the data order fast-forwarded to the resume point: a resumed run
        # consumes the batches of an uninterrupted one
        data = exp.loader.infinite(start_step=start_step)
        fid_by_step: Dict[int, float] = {}
        t0 = time.perf_counter()
        with GracefulShutdown() as stop:
            state, step, preempted, last_saved = _train_steps(
                exp, state, data, start_step, n_steps, metrics_w,
                fid_by_step, stop, log, history)
        data.close()
        seconds = time.perf_counter() - t0
        out = dict(state=state, step=step, preempted=preempted,
                   checkpoint=exp.ckpt.path(step), seconds=seconds)
        if preempted:  # the checkpoint is already written
            return out
        if last_saved != step:
            exp.ckpt.save(state, step, wait=True)
        else:
            exp.ckpt.wait()
        # the best-FID checkpoint and the final evaluation on it at the
        # config's n_samples (reference train_lfm.py:328-338)
        if fid_by_step:
            best = min(fid_by_step, key=fid_by_step.get)
            log(f"best small-FID {fid_by_step[best]:.6g} at step {best}")
            with open(os.path.join(exp.workdir, "best_ckpt.txt"), "w") as f:
                f.write(f"{best} {fid_by_step[best]}\n")
            ema = exp.ckpt.restore_params(best, ema=True,
                                          map_location=exp.device)
            final = _eval_fid(exp, ema, best,
                              n_samples=cfg["sample"]["n_samples"],
                              tag="final")
            del ema
            if final is not None:
                log(f"final FID ({cfg['sample']['n_samples']} samples) "
                    f"{final:.6g}")
                metrics_w.write(best, {"final_fid": final})
        return out
    finally:
        if log_file:
            close_log_file(log_file)


def _train_steps(exp: Experiment, state: TrainState, data, start_step: int,
                 n_steps: int, metrics_w: MetricsWriter,
                 fid_by_step: Dict[int, float], stop: GracefulShutdown,
                 log: Callable[[str], None], history: Optional[List[dict]]):
    """The step loop. Returns ``(state, step, preempted, last saved
    step)``; on preemption the checkpoint has been written."""
    cfg, tr = exp.config, exp.config["train"]
    step_fn = exp.train_step_fn()
    is_main = exp.rank == 0
    profile_dir = tr.get("profile_dir")
    prof, last_saved = None, None
    t_last = time.time()
    step = start_step
    while step < n_steps:
        if profile_dir and step == start_step + 10:
            prof = start_trace(profile_dir)
        m = step_fn(state, device_batch(next(data), exp.device), state.rng)
        step += 1
        if prof is not None and step == start_step + 13:
            stop_trace(prof)
            prof = None
            log(f"profile trace -> {profile_dir}")
        scalars = None
        if history is not None:
            scalars = {k: float(v) for k, v in m.items()}
            history.append(scalars)
        logging_step = step % tr["log_interval"] == 0
        if logging_step or step in (start_step + 1, n_steps):
            scalars = scalars or {k: float(v) for k, v in m.items()}
            log(f"step {step}/{n_steps}: loss {scalars['loss']:.6f} "
                f"grad_norm {scalars['grad_norm']:.4f} lr "
                f"{scalars.get('lr', math.nan):.3e}"
                + (" (non-finite: update skipped)"
                   if scalars.get("nonfinite_skip") else ""))
        if logging_step and is_main:
            # images a second over the steps since the last record, the
            # global batch, evaluation and checkpoint time left out
            dt = time.time() - t_last
            scalars["imgs_per_sec"] = (tr["log_interval"] * exp.global_batch
                                       / max(dt, 1e-9))
            metrics_w.write(step, scalars)
            t_last = time.time()
        if step % tr["eval_interval"] == 0 and is_main:
            _vis(exp, state, step)
            t_last = time.time()
        if step % tr["save_interval"] == 0:
            exp.ckpt.save(state, step)
            last_saved = step
            # FID on process 0 only (eval sampling is replicated work;
            # writing from every process would duplicate records)
            fid = _eval_fid(exp, state.ema_params, step) if is_main else None
            if fid is not None:
                fid_by_step[step] = fid
                metrics_w.write(step, {"fid": fid})
            t_last = time.time()
        # graceful preemption at the step boundary: SIGTERM latched by the
        # guard (under DDP, on any process: every process stops at this
        # same step). ONE checkpoint, then a clean return; resume
        # continues bit-exactly
        if exp.ckpt.reached_preemption(step, stop.requested):
            if prof is not None:
                stop_trace(prof)
            if last_saved != step:
                exp.ckpt.save(state, step, wait=True)
                last_saved = step
            else:
                exp.ckpt.wait()
            log(f"preemption at step {step}: checkpoint saved, exiting "
                "cleanly")
            if is_main:
                metrics_w.write(step, {"preempted": 1.0})
            return state, step, True, last_saved
    if prof is not None:  # the run ended inside the trace window
        stop_trace(prof)
    return state, step, False, last_saved


def _vis(exp: Experiment, state: TrainState, step: int) -> None:
    """The periodic sample grid, ``vis/<step>.png`` (reference
    train_lfm.py:250-306): decoded images, or without VAE weights the
    first three latent channels min-max normalised."""
    n = exp.config["vis_num"]
    gen = seeded(exp.seed, 2 + step, exp.device)
    cond = exp.eval_cond(gen, n)
    latents = exp.sample_latents(state.ema_params, gen, n, cond)
    decode = exp.vae()
    out_path = os.path.join(exp.workdir, "vis", f"{step}.png")
    if decode:
        with torch.no_grad():
            imgs = decode(latents)
        imgs = unpreprocess(np.asarray(imgs.float().cpu()))
    else:
        lat = np.asarray(latents.float().cpu())
        imgs = (lat - lat.min()) / max(lat.max() - lat.min(), 1e-8)
        imgs = imgs[..., :3]
    save_image(make_grid(imgs), out_path)
    logger.info("vis saved: %s", out_path)


def _eval_fid(exp: Experiment, params: Dict[str, torch.Tensor], step: int,
              n_samples: Optional[int] = None, tag: str = ""
              ) -> Optional[float]:
    """FID of samples from ``params`` (EMA weights) against the dataset's
    ``fid_stat`` (reference eval_step, train_lfm.py:185-230), or None
    without statistics, without a decode (no VAE file; ``sample.fid_decode
    = "identity"`` takes the samples as images) or without the Inception
    weights (a warning: a missing file never kills a run). Per-save
    evaluations take min(``sample.n_samples``, 2048) samples; the final one
    on the best checkpoint ``n_samples``. The images go to
    ``eval/<step><tag>``."""
    cfg = exp.config
    fid_stat = getattr(exp.dataset, "fid_stat", None)
    if not fid_stat or not os.path.exists(fid_stat):
        return None
    if cfg["sample"].get("fid_decode", "vae") == "identity":
        decode = lambda z: z  # noqa: E731
    else:
        decode = exp.vae()
        if not decode:
            return None
    from ..evals import fid as fid_mod

    try:
        feat = exp.featurizer(cfg["sample"].get("fid_weights") or None)
    except FileNotFoundError as e:  # missing Inception weights: skip FID
        logger.warning("FID skipped: %s", e)
        return None

    secs = dict(step=step, tag=tag, sample=0.0, decode=0.0)

    def sample_images(gen, n):
        t0 = time.perf_counter()
        cond = exp.eval_cond(gen, n)
        lat = exp.sample_latents(params, gen, n, cond)
        _sync(exp.device)
        t1 = time.perf_counter()
        with torch.no_grad():
            imgs = decode(lat)
        _sync(exp.device)
        secs["sample"] += t1 - t0
        secs["decode"] += time.perf_counter() - t1
        return imgs

    out_dir = os.path.join(exp.workdir, "eval", f"{step}{tag}")
    n_eval = n_samples or min(cfg["sample"]["n_samples"], 2048)
    t0 = time.perf_counter()
    sample2dir(sample_images, n_eval, cfg["sample"]["mini_batch_size"],
               out_dir, seeded(exp.seed, 3 + step, exp.device),
               unpreprocess=unpreprocess)
    secs["write"] = time.perf_counter() - t0 - secs["sample"] - secs["decode"]
    # fid_given_paths, timed in two parts: the statistics (Inception, the
    # PNGs read) and the Frechet distance (a 2048 x 2048 sqrtm on the host)
    t0 = time.perf_counter()
    m1, s1 = fid_mod.compute_statistics_of_path(fid_stat)
    m2, s2 = fid_mod.compute_statistics_of_path(out_dir, feat)
    t1 = time.perf_counter()
    fid = fid_mod.frechet_distance(m1, s1, m2, s2)
    secs.update(inception=t1 - t0, frechet=time.perf_counter() - t1,
                n=n_eval, fid=fid)
    exp.eval_seconds.append(secs)
    logger.info("FID %s: %s", out_dir, dct2str(secs))
    return fid


def _sync(device: torch.device) -> None:
    """Wait for the card, so that host clocks time its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
