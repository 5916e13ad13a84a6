"""uspace_tpu_torch's training experiment (train/loop.py and what it
reaches) on the CPU, against the JAX package where there is a counterpart.

Against JAX: the metrics records and their formatting, ``hparams_from_argv``
and ``strip_prefix_in_dir``; the evaluation solve's keyword arguments; the
loader's first batches for a global batch of 8 over 1 and 2 processes;
reference-format checkpoints (``module.`` and ``model.diffusion_model.``
prefixes inside a ``state_dict`` wrapper) loaded into both packages, whose
fields then agree to f32 1e-4 (the same arithmetic summed in another
order); ``load_pretrained_nnet`` with every surgery on one reference file,
taking the same tensors from it in both packages.

The port alone, on ``synthetic_smoke`` (a few seconds a run): a 10-step
run writes the JAX loop's artefacts with the in-loop FID pipeline (identity
decode, the random featurizer, seeded 2048-d statistics); a SIGTERM at
step 3 and a resume end bit-equal to an uninterrupted run (params, EMA,
Adam moments, the generator); two runs from one seed are bit-equal; the
stage-delta knob and its refusals. The ``slow`` tests port the JAX
package's slow loop tests and run both loops from one set of weights with
the port's draws fed to JAX.
"""

import glob
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu_torch.cli import train_lfm
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.models import UNet, UViT
from uspace_tpu_torch.parallel import distributed
from uspace_tpu_torch.train import loop
from uspace_tpu_torch.train.checkpoint import load_pretrained_nnet
from uspace_tpu_torch.train.preemption import GracefulShutdown

CPU = torch.device("cpu")
UVIT = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=2,
            num_heads=4)
UNET = dict(image_size=8, in_channels=4, out_channels=4, model_channels=16,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=8, use_spatial_transformer=True,
            transformer_depth=1, context_dim=8)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the loop's loader threads, torch and the
    host's BLAS otherwise oversubscribe the CPU under Tier-1's six
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smoke(**train):
    cfg = get_config("synthetic_smoke")
    cfg["train"].update(train)
    cfg["dl"]["num_workers"] = 2
    return cfg


def _flat_np(sd):
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


# --- logging, hparams, misc against JAX -------------------------------------


def test_metrics_writer_and_dct2str_match_jax(tmp_path):
    from uspace_tpu.utils import logging_utils as jlog
    from uspace_tpu_torch.utils import logging_utils as tlog

    metrics = {"loss": torch.tensor(0.25), "lr": np.float32(1e-4),
               "grad_norm": 3, "tag": "x", "arr": [1, 2]}
    mine, ref = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    seen = []
    w = tlog.MetricsWriter(str(mine), use_wandb=True)  # no wandb: JSONL
    w.add_sink(lambda step, rec: seen.append(step))
    jw = jlog.MetricsWriter(str(ref))
    for step in (1, 5):
        w.write(step, metrics)
        jw.write(step, metrics)
    a = [json.loads(line) for line in open(mine)]
    b = [json.loads(line) for line in open(ref)]
    for r in a + b:
        assert isinstance(r.pop("time"), float)
    assert a == b and seen == [1, 5]
    assert tlog.dct2str(metrics) == jlog.dct2str(metrics)
    assert tlog.cnt_params(UViT(**UVIT, device="cpu")) == sum(
        p.numel() for p in UViT(**UVIT, device="cpu").parameters())


def test_hparams_from_argv_matches_jax():
    from uspace_tpu.cli.train_lfm import hparams_from_argv as jhp

    for argv in ([], ["--config=x.py"],
                 ["--config.train.batch_size=64", "--workdir=w",
                  "--config.optimizer.lr=2e-4", "--config.seed"]):
        assert train_lfm.hparams_from_argv(argv) == jhp(argv)
    cfg = get_config("synthetic_smoke")
    train_lfm.apply_override(cfg, "--config.train.batch_size=64")
    train_lfm.apply_override(cfg, "--config.sample.fid_weights=random")
    train_lfm.apply_override(cfg, "--config.nnet.mlp_ratio=2.0")
    assert cfg["train"]["batch_size"] == 64
    assert cfg["sample"]["fid_weights"] == "random"
    assert cfg["nnet"]["mlp_ratio"] == 2.0


def test_strip_prefix_in_dir_matches_jax(tmp_path):
    from uspace_tpu.utils.misc import strip_prefix_in_dir as jstrip
    from uspace_tpu_torch.utils.misc import strip_prefix_in_dir

    got = {}
    for name, fn in (("mine", strip_prefix_in_dir), ("ref", jstrip)):
        d = tmp_path / name
        d.mkdir()
        for f in ("tail_a.npy", "tail_b_tail_.npy", "c.npy", "tail_"):
            (d / f).write_text(f)
        got[name] = sorted(os.path.basename(p) for p in fn(str(d)))
        assert sorted(os.listdir(d)) == ["a.npy", "b_tail_.npy", "c.npy",
                                         "tail_"]
        (d / "tail_c.npy").write_text("x")
        with pytest.raises(FileExistsError):
            fn(str(d))
    assert got["mine"] == got["ref"]


def test_graceful_shutdown_latches_sigterm_and_restores():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        outer = signal.getsignal(signal.SIGTERM)
        with GracefulShutdown() as g:
            assert g.installed and not g.requested
            signal.raise_signal(signal.SIGTERM)
            assert g.requested and seen == [signal.SIGTERM]  # chained
        assert signal.getsignal(signal.SIGTERM) is outer
        # off the main thread the guard is inert
        box = {}

        def body():
            with GracefulShutdown() as g2:
                box["installed"], box["requested"] = g2.installed, g2.requested
        t = threading.Thread(target=body)
        t.start()
        t.join()
        assert box == {"installed": False, "requested": False}
        assert signal.getsignal(signal.SIGTERM) is outer
    finally:
        signal.signal(signal.SIGTERM, prev)


# --- the evaluation solve against JAX -------------------------------------


def test_solver_kwargs_match_jax(tmp_path):
    from uspace_tpu.configs.synthetic_smoke import get_config as jcfg
    from uspace_tpu.train.loop import Experiment as JaxExperiment

    jc = jcfg()
    jc.sample.sample_steps = 8
    jexp = JaxExperiment(jc, str(tmp_path / "jax"))
    cfg = get_config("synthetic_smoke")
    cfg["sample"]["sample_steps"] = 8
    exp = loop.Experiment(cfg, str(tmp_path / "port"), device="cpu")
    assert exp.solver_kwargs() == dict(jexp.solver_kwargs())
    assert exp.solver_kwargs()["solver_fix_step"] == 1.0 / 8
    assert exp.solver_kwargs(4) == dict(jexp.solver_kwargs(4))
    for sk in ({"solver": "fixed", "solver_fix": "rk4",
                "solver_fix_step": 0.1},
               {"solver": "adaptive", "solver_adaptive": "dopri5",
                "rtol": 1e-5, "atol": 1e-5, "controller": "pi"}):
        jc.sample.solver_kwargs = sk
        exp.config["sample"]["solver_kwargs"] = dict(sk)
        assert exp.solver_kwargs() == dict(jexp.solver_kwargs()), sk


def test_stage_delta_field_knob(tmp_path):
    """``sample.solver_kwargs.field = "stage_delta_int8"`` routes the
    evaluation solve through the stage-delta int8 field (tests/
    test_loop.py:143-227): close to the plain adaptive solve from the same
    z, and refused for a fixed solve and for a conditioned one."""
    cfg = get_config("synthetic_smoke")
    cfg["sample"]["solver_kwargs"].update(solver="adaptive", safety=1.0,
                                          field="stage_delta_int8")
    exp = loop.Experiment(cfg, str(tmp_path / "a"), device="cpu")
    params = exp.state.ema_params
    lat = exp.sample_latents(params, torch.Generator().manual_seed(0), 2)
    assert lat.shape == (2, 8, 8, 4) and torch.isfinite(lat).all()
    plain = get_config("synthetic_smoke")
    plain["sample"]["solver_kwargs"].update(solver="adaptive", safety=1.0)
    ref = loop.Experiment(plain, str(tmp_path / "b"), device="cpu"
                          ).sample_latents(params,
                                           torch.Generator().manual_seed(0), 2)
    rel = float((lat - ref).norm() / ref.norm())
    assert rel < 0.05, rel
    # the host driver's keys select the same (host-driven) solve
    exp.config["sample"]["solver_kwargs"].update(driver="host",
                                                 program="stages")
    same = exp.sample_latents(params, torch.Generator().manual_seed(0), 2)
    assert torch.equal(same, lat)
    exp.config["sample"]["solver_kwargs"]["solver"] = "fixed"
    with pytest.raises(ValueError):
        exp.sample_latents(params, torch.Generator().manual_seed(0), 2)
    exp.config["sample"]["solver_kwargs"]["solver"] = "adaptive"
    with pytest.raises(NotImplementedError):
        exp.sample_latents(params, torch.Generator().manual_seed(0), 2,
                           cond={"y": torch.zeros(2, dtype=torch.long)})
    exp.config["sample"]["solver_kwargs"]["field"] = "other"
    with pytest.raises(NotImplementedError):
        exp.sample_latents(params, torch.Generator().manual_seed(0), 2)


def test_parallel_layouts_not_ported_are_refused(tmp_path):
    for key, value, exc in (("fsdp", 2, NotImplementedError),
                            ("tp", 2, NotImplementedError),
                            ("dp", 4, ValueError)):
        cfg = get_config("synthetic_smoke")
        cfg["parallel"][key] = value
        with pytest.raises(exc):
            loop.Experiment(cfg, str(tmp_path), device="cpu")


@pytest.mark.parametrize("procs", [1, 2])
def test_first_batches_for_a_global_batch(monkeypatch, tmp_path, procs):
    """A global batch of 8 over ``procs`` processes: each process's loader
    yields the JAX loop's batches for its index (local batch 8 / procs), and
    the processes' rows, interleaved, are the one-process batch: row i of
    it is row i // procs of process i % procs, the rows whose draws that
    process keeps (core/interpolant.draw)."""
    from uspace_tpu.data.datasets import get_dataset as jget
    from uspace_tpu.data.loader import DataLoader as JaxLoader

    cfg = _smoke(batch_size=8 // procs)
    single = loop.Experiment(_smoke(batch_size=8), str(tmp_path / "one"),
                             device="cpu").loader.infinite()
    ref_batches = [next(single)["x"] for _ in range(3)]
    per_rank = []
    for rank in range(procs):
        monkeypatch.setattr(distributed, "process_index", lambda r=rank: r)
        monkeypatch.setattr(distributed, "process_count", lambda: procs)
        exp = loop.Experiment(cfg, str(tmp_path / f"r{rank}"), device="cpu")
        assert exp.global_batch == 8 and exp.local_batch == 8 // procs
        it = exp.loader.infinite()
        mine = [next(it)["x"] for _ in range(3)]
        jds = jget(**cfg["dataset"]).get_split("train")
        jit_ = JaxLoader(jds, 8 // procs, seed=cfg["seed"] if "seed" in cfg
                         else 0, num_workers=1, process_index=rank,
                         process_count=procs).infinite(start_step=0)
        for a in mine:
            np.testing.assert_array_equal(a, next(jit_)["x"])
        per_rank.append(mine)
    for k in range(3):
        for rank in range(procs):
            np.testing.assert_array_equal(ref_batches[k][rank::procs],
                                          per_rank[rank][k])


# --- reference checkpoints and surgeries against JAX ----------------------


def _jax_uvit(**kw):
    from uspace_tpu.models import UViT as JaxUViT

    return JaxUViT(**UVIT, attn_impl="xla", **kw)


def _tree_shapes(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.shape(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_checkpoint_prefixes_load_in_both(tmp_path):
    """A DDP-saved U-ViT (``module.*``) and an SD LDM UNet saved under DDP
    (``module.model.diffusion_model.*``), each in a ``state_dict`` wrapper,
    load strictly into the port and into JAX, and both compute the same
    field."""
    from uspace_tpu.codecs.convert import (
        load_torch_checkpoint,
        unet_torch_to_flax,
        uvit_torch_to_flax,
    )
    from uspace_tpu.models.unet import UNet as JaxUNet
    from uspace_tpu_torch.codecs.convert import load_reference_nnet

    r = np.random.default_rng(0)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    for kind, prefix in (("uvit", "module."),
                         ("unet", "module.model.diffusion_model.")):
        if kind == "uvit":
            src = UViT(**UVIT, attn_impl="xla", device="cpu")
            jm = _jax_uvit()
            to_flax, fresh = uvit_torch_to_flax, lambda: UViT(
                **UVIT, attn_impl="xla", device="cpu")
        else:
            src = UNet(**UNET, attn_impl="xla", device="cpu")
            jm = JaxUNet(**UNET, attn_impl="xla")
            to_flax, fresh = unet_torch_to_flax, lambda: UNet(
                **UNET, attn_impl="xla", device="cpu")
        src.init_weights(torch.Generator().manual_seed(3))
        path = str(tmp_path / f"{kind}.pth")
        torch.save({"state_dict": {prefix + k: v for k, v in
                                   src.state_dict().items()}}, path)
        port = load_reference_nnet(fresh(), path)
        jparams = {"params": to_flax(load_torch_checkpoint(path))}
        init = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.asarray(x), jnp.asarray(t))
        assert _tree_shapes(jparams) == _tree_shapes(init), kind
        ref, _ = jax.jit(jm.apply)(jparams, jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            out, _ = port(torch.from_numpy(x), torch.from_numpy(t))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                                   err_msg=kind)


_JAX_INITS = {}


def _jax_init(unet: bool):
    """A JAX param tree of the toy UNet or class-conditional U-ViT, its
    shapes from ``jax.eval_shape`` (no compile), its values seeded numpy
    draws standing in for a fresh init."""
    if unet not in _JAX_INITS:
        x, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))
        if unet:
            from uspace_tpu.models.unet import UNet as JaxUNet

            shapes = jax.eval_shape(JaxUNet(**UNET, attn_impl="xla").init,
                                    jax.random.PRNGKey(1), x, t)
        else:
            shapes = jax.eval_shape(_jax_uvit(num_classes=5).init,
                                    jax.random.PRNGKey(1), x, t,
                                    jnp.zeros((1,), jnp.int32))
        r = np.random.default_rng(int(unet))
        _JAX_INITS[unet] = jax.tree.map(
            lambda a: r.standard_normal(a.shape).astype(a.dtype),
            dict(shapes))
    return _JAX_INITS[unet]


@pytest.mark.parametrize("surgery", [None, "nnet_only", "mscoco_or_in256",
                                     "unet", "unet_remove_attention"])
def test_load_pretrained_nnet_surgeries_match_jax(tmp_path, surgery):
    """One reference file, each surgery: the port and JAX take the same
    tensors from it and keep their own fresh init for the rest."""
    from uspace_tpu.train.checkpoint import load_pretrained_nnet as jload
    from uspace_tpu_torch.codecs.convert import (
        unet_flax_to_torch,
        uvit_flax_to_torch,
    )

    unet = surgery in ("unet", "unet_remove_attention")
    jinit = _jax_init(unet)
    if unet:
        make = lambda: UNet(**UNET, attn_impl="xla", device="cpu")  # noqa
        to_torch, prefix = unet_flax_to_torch, "model.diffusion_model."
    else:
        make = lambda: UViT(**UVIT, num_classes=5, attn_impl="xla",  # noqa
                            device="cpu")
        to_torch, prefix = uvit_flax_to_torch, ""
    src = make().init_weights(torch.Generator().manual_seed(0))
    path = str(tmp_path / "nnet.pth")
    file = {k: v.clone() for k, v in src.state_dict().items()}
    torch.save({prefix + k: v for k, v in file.items()}, path)
    port0 = make().init_weights(torch.Generator().manual_seed(1))
    init = _flat_np(port0.state_dict())
    port = _flat_np(load_pretrained_nnet(path, port0, surgery).state_dict())
    jres = {k: np.asarray(v) for k, v in to_torch(
        jload(path, dict(jinit), surgery)).items()}
    jini = {k: np.asarray(v) for k, v in to_torch(jinit).items()}
    file = _flat_np(file)
    assert port.keys() == jres.keys() == file.keys()
    # a tensor whose fresh init equals the file's (zero biases) cannot show
    # whether it was taken
    keys = {k for k in file if not np.array_equal(init[k], file[k])
            and not np.array_equal(jini[k], file[k])}
    taken = {k for k in keys if np.array_equal(port[k], file[k])}
    assert taken == {k for k in keys if np.array_equal(jres[k], file[k])}
    for k in keys - taken:  # dropped: each keeps its own init
        np.testing.assert_array_equal(port[k], init[k])
        np.testing.assert_array_equal(jres[k], jini[k])
    dropped = keys - taken
    if surgery in (None, "unet"):
        assert not dropped
    elif surgery == "unet_remove_attention":
        assert dropped and all(".attn2." in k for k in dropped)
    else:
        want = {"nnet_only": ("label_emb", "pos_embed"),
                "mscoco_or_in256": ("pos_embed",)}[surgery]
        assert dropped == {k for k in keys if k.startswith(want)}


def test_load_pretrained_nnet_refusals(tmp_path):
    from uspace_tpu.train.checkpoint import load_pretrained_nnet as jload

    m = UViT(**UVIT, device="cpu")
    sd = dict(m.state_dict())
    path = str(tmp_path / "nnet.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="surgery"):
        load_pretrained_nnet(path, m, "bogus")
    with pytest.raises(ValueError, match="surgery"):
        jload(path, {"params": {}}, "bogus")
    sd["pos_embed"] = torch.zeros(1, 3, 32)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_nnet(path, m, None)
    load_pretrained_nnet(path, m, "mscoco_or_in256")  # pos_embed dropped
    del sd["pos_embed"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="pos_embed"):
        load_pretrained_nnet(path, m, None)  # strict


# --- the port's own runs ----------------------------------------------------


def _fid_config(tmp_path):
    """tests/test_loop.py:94-140's setup: a pixel-like 3-channel model, so
    that the identity decode feeds RGB images, seeded 2048-d statistics,
    the random featurizer."""
    acts = np.random.default_rng(0).standard_normal((64, 2048))
    stat = str(tmp_path / "fid_stats_synth.npz")
    np.savez(stat, mu=acts.mean(0), sigma=np.cov(acts, rowvar=False))
    cfg = _smoke()
    cfg["z_shape"] = (3, 8, 8)
    cfg["nnet"]["in_chans"] = 3
    cfg["dataset"] = dict(name="synthetic", num=32, shape=(8, 8, 6),
                          fid_stat=stat)
    cfg["sample"].update(fid_decode="identity", fid_weights="random",
                         n_samples=4, mini_batch_size=4)
    return cfg


def _fid_loop(tmp_path):
    """10 steps, a save and an FID every 5, a grid at 10: checkpoints 5 and
    10, ``vis/10.png``, ``metrics.jsonl`` records of JAX's keys, the
    evaluations' images, ``best_ckpt.txt`` naming the smaller FID and the
    final FID on its samples; then a resume to step 12."""
    cfg = _fid_config(tmp_path)
    wd = str(tmp_path / "run")
    state = loop.train(cfg, wd, device="cpu")
    assert int(state.step) == 10
    steps = sorted(int(os.path.basename(p)[:-3])
                   for p in glob.glob(wd + "/ckpts/*.pt"))
    assert steps == [5, 10]
    assert os.path.exists(wd + "/vis/10.png")
    assert os.path.getsize(wd + "/train.log") > 0
    recs = [json.loads(line) for line in open(wd + "/metrics.jsonl")]
    train_recs = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train_recs] == [5, 10]
    for r in train_recs:
        assert set(r) == {"step", "time", "loss", "grad_norm", "lr",
                          "nonfinite_skip", "imgs_per_sec"}
    fids = [r["fid"] for r in recs if "fid" in r]
    assert len(fids) == 2 and all(np.isfinite(f) for f in fids), recs
    best_step, best_fid = open(wd + "/best_ckpt.txt").read().split()
    assert int(best_step) in (5, 10) and float(best_fid) == min(fids)
    finals = [r for r in recs if "final_fid" in r]
    assert len(finals) == 1 and finals[0]["step"] == int(best_step)
    assert finals[0]["final_fid"] == float(best_fid)
    evals = sorted(os.listdir(wd + "/eval"))
    assert evals == sorted(["5", "10", f"{best_step}final"])
    for d in evals:
        assert sorted(os.listdir(f"{wd}/eval/{d}")) == [f"{i}.png"
                                                        for i in range(4)]
    # resume continues from the latest checkpoint
    cfg["train"]["n_steps"] = 12
    assert int(loop.train(cfg, wd, device="cpu").step) == 12
    assert sorted(int(os.path.basename(p)[:-3])
                  for p in glob.glob(wd + "/ckpts/*.pt")) == [5, 10, 12]


def test_loop_writes_the_jax_artefacts_with_in_loop_fid(tmp_path,
                                                        monkeypatch):
    """The in-loop FID pipeline, every stage of it real (sampling, the
    identity decode, PNGs, the random Inception, the statistics, best
    checkpoint and final evaluation) but the Fréchet distance's 2048 x 2048
    sqrtm, which takes 30 s to minutes of host time a call here: a cheap
    function of the same statistics stands in for it (the distance itself
    is held to JAX's in tests/test_torch_fid.py; the slow test below runs
    the pipeline with it)."""
    from uspace_tpu_torch.evals import fid

    monkeypatch.setattr(fid, "frechet_distance", lambda m1, s1, m2, s2: float(
        ((m1 - m2) ** 2).sum() + np.trace(s1) + np.trace(s2)))
    _fid_loop(tmp_path)


@pytest.mark.slow
def test_in_loop_fid_pipeline(tmp_path):
    """tests/test_loop.py:94-140 on the port: the same run with the real
    Fréchet distance."""
    _fid_loop(tmp_path)


def _state_arrays(state):
    out = {"step": state.step.numpy().copy(),
           "count": state.opt_state.count.numpy().copy(),
           "rng": state.rng.get_state().numpy().copy()}
    for name, d in (("p", state.params), ("e", state.ema_params),
                    ("m", state.opt_state.mu), ("v", state.opt_state.nu)):
        out.update({f"{name}/{k}": v.detach().numpy().copy()
                    for k, v in d.items()})
    return out


def test_sigterm_resume_is_bit_exact_and_runs_are_deterministic(
        tmp_path, monkeypatch):
    """A real SIGTERM from the step-3 metrics write: one checkpoint, a
    ``preempted`` record, a clean return at step 3; the resumed run ends
    bit-equal to an uninterrupted run, and two uninterrupted runs from one
    seed are bit-equal."""
    def cfg():
        return _smoke(n_steps=5, log_interval=1, eval_interval=100,
                      save_interval=100)

    ctrl = _state_arrays(loop.train(cfg(), str(tmp_path / "a"), device="cpu"))
    again = _state_arrays(loop.train(cfg(), str(tmp_path / "b"),
                                     device="cpu"))
    losses = [[json.loads(line)["loss"] for line in
               open(tmp_path / d / "metrics.jsonl")] for d in "ab"]
    assert losses[0] == losses[1] and len(losses[0]) == 5
    for k in ctrl:
        np.testing.assert_array_equal(ctrl[k], again[k], err_msg=k)

    real = loop.MetricsWriter

    class Interrupting(real):
        def write(self, step, metrics):
            super().write(step, metrics)
            if step == 3 and "loss" in metrics:
                signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(loop, "MetricsWriter", Interrupting)
    wd = str(tmp_path / "int")
    prev = signal.getsignal(signal.SIGTERM)
    state = loop.train(cfg(), wd, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is prev
    assert int(state.step) == 3
    monkeypatch.setattr(loop, "MetricsWriter", real)
    assert os.listdir(wd + "/ckpts") == ["3.pt"]
    recs = [json.loads(line) for line in open(wd + "/metrics.jsonl")]
    assert [r["step"] for r in recs if r.get("preempted")] == [3]
    resumed = _state_arrays(loop.train(cfg(), wd, device="cpu"))
    assert resumed.keys() == ctrl.keys()
    for k in ctrl:
        np.testing.assert_array_equal(resumed[k], ctrl[k], err_msg=k)
    recs = [json.loads(line) for line in open(wd + "/metrics.jsonl")]
    assert [r["loss"] for r in recs if "loss" in r] == losses[0]


def test_run_and_export_round_trip(tmp_path):
    """``train_lfm.run`` through the loop: its history, its checkpoint
    ``<workdir>/ckpts/<n_steps>.pt``, a second call into that workdir
    refused; ``export_torch`` writes the EMA
    weights as a reference ``.pth`` that loads strictly into a fresh model
    (and through ``load_reference_nnet``)."""
    from uspace_tpu_torch.cli import export_torch
    from uspace_tpu_torch.codecs.convert import load_reference_nnet

    logs = []
    out = train_lfm.run("synthetic_smoke", n_steps=3, device="cpu",
                        workdir=str(tmp_path), log=logs.append)
    assert out["checkpoint"] == str(tmp_path / "ckpts" / "3.pt")
    assert len(out["history"]) == 3 and len(logs) == 3
    with pytest.raises(ValueError, match="at or past n_steps 3"):
        train_lfm.run("synthetic_smoke", n_steps=3, device="cpu",
                      workdir=str(tmp_path))
    pth = str(tmp_path / "nnet_ema.pth")
    export_torch.main(["--ckpt", str(tmp_path / "ckpts"), "--out", pth])
    cfg = get_config("synthetic_smoke")
    fresh = load_reference_nnet(
        train_lfm.build_train_model(cfg, CPU, seed=5), pth)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, out["state"].ema_params[k]), k
    export_torch.main(["--ckpt", out["checkpoint"], "--out", pth, "--raw"])
    raw = torch.load(pth, weights_only=True)
    for k, v in raw.items():
        assert torch.equal(v, out["state"].params[k].detach()), k


def test_checkpoint_manager_and_profile_window(tmp_path):
    """``max_to_keep`` keeps the newest files; ``restore`` without a
    checkpoint raises FileNotFoundError; ``train.profile_dir`` traces steps
    start + 10 to start + 13 with torch.profiler."""
    from uspace_tpu_torch.train.checkpoint import CheckpointManager

    exp = loop.Experiment(_smoke(), str(tmp_path / "m"), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(exp.state)
    for step in (1, 2, 3):
        exp.state.step.fill_(step)
        mgr.save(exp.state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore(exp.state, 2).step.item() == 2
    assert set(mgr.restore_params(3)) == set(exp.state.params)
    cfg = _smoke(n_steps=13, log_interval=100, save_interval=100,
                 eval_interval=100, profile_dir=str(tmp_path / "prof"))
    loop.train(cfg, str(tmp_path / "p"), device="cpu")
    assert os.listdir(tmp_path / "prof")


def test_train_cli_workdir_layout(tmp_path):
    """``main`` trains into <workdir>/<config>/<hparams of the overrides>,
    flags read as their overrides."""
    train_lfm.main(["--config", "synthetic_smoke", "--device", "cpu",
                    "--workdir", str(tmp_path), "--n_steps", "2",
                    "--config.train.log_interval=1"])
    wd = tmp_path / "synthetic_smoke" / "n_steps=2-log_interval=1"
    assert sorted(os.listdir(wd / "ckpts")) == ["2.pt"]
    assert len(open(wd / "metrics.jsonl").readlines()) == 2


# --- slow: the JAX package's slow loop tests, and both loops at once -------


@pytest.mark.slow
def test_train_loop_unet(tmp_path):
    """The loop drives the SD-UNet family (uncond, zero-context fallback),
    tests/test_loop.py:40-67."""
    cfg = get_config("synthetic_unet")
    cfg["nnet"] = dict(name="unet_t2i", **UNET)
    cfg["z_shape"] = (4, 8, 8)
    cfg["vis_num"] = 2
    cfg["train"].update(n_steps=3, batch_size=8, log_interval=1,
                        eval_interval=3, save_interval=3)
    cfg["dataset"] = dict(name="synthetic", num=8, shape=(8, 8, 8))
    cfg["dl"] = dict(num_workers=1)
    cfg["sample"].update(sample_steps=2, mini_batch_size=2)
    state = loop.train(cfg, str(tmp_path / "unet_run"), device="cpu")
    assert int(state.step) == 3
    assert os.path.exists(tmp_path / "unet_run" / "vis" / "3.png")


@pytest.mark.slow
def test_dissect_loads_the_loops_checkpoint(tmp_path):
    """The editing CLIs open the loop's checkpoints (tests/test_loop.py:
    70-91's sample-from-checkpoint, on the port's dissect loader): the
    latest ``<step>.pt``'s EMA weights."""
    from uspace_tpu_torch.cli.dissect_common import load_nnet_params

    cfg = _smoke()
    state = loop.train(cfg, str(tmp_path / "run"), device="cpu")
    cfg["dissection"]["ckpt_path_to_dissect"] = str(tmp_path / "run" /
                                                     "ckpts")
    m = load_nnet_params(cfg, train_lfm.build_train_model(cfg, CPU, seed=9))
    for k, v in m.state_dict().items():
        assert torch.equal(v, state.ema_params[k]), k


@pytest.mark.slow
def test_both_loops_agree_from_one_set_of_weights(tmp_path, monkeypatch):
    """The JAX loop and the port's on ``synthetic_smoke`` (the JAX config:
    its ``synthetic`` data and batch of 8), from one set of weights
    carried across, the port's draws fed to JAX in its order (moments
    noise, t, path noise) as tests/test_torch_train.py does: per-step
    losses within 1e-5 and final params within 1e-4 (f32, the train step's
    tolerances)."""
    import uspace_tpu.train.loop as jloop
    from uspace_tpu.configs.synthetic_smoke import get_config as jcfg
    from uspace_tpu.train.step import make_train_step as make_jax_step
    from uspace_tpu_torch.codecs.convert import uvit_flax_to_torch

    n = 4
    jc = jcfg()
    jc.train.n_steps = n
    jc.train.log_interval = 1
    jc.train.save_interval = jc.train.eval_interval = 100
    jc.dl.num_workers = 1
    jexp = jloop.Experiment(jc, str(tmp_path / "jax"))
    params = jax.tree.map(np.asarray, jexp.state.params)

    cfg = _smoke(n_steps=n, log_interval=1, save_interval=100,
                 eval_interval=100)
    cfg["dataset"] = dict(jc.dataset)
    cfg["vis_num"] = jc.vis_num
    exp = loop.Experiment(cfg, str(tmp_path / "port"), device="cpu",
                          attn_impl=jexp.train_model.attn_impl)
    exp.train_model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in
         uvit_flax_to_torch(params).items()}, strict=True)
    exp.state = exp.state.create(dict(exp.train_model.named_parameters()),
                                 exp.tx, rng=exp.state.rng)
    g = torch.Generator().set_state(exp.state.rng.get_state())
    draws = []
    x_shape = (8, 8, 8, 4)
    for _ in range(n):
        draws.append(torch.randn(x_shape, generator=g).numpy())
        draws.append(torch.rand((8,), generator=g).numpy())
        draws.append(torch.randn(x_shape, generator=g).numpy())
    hist = []
    out = loop.fit(exp, log=lambda s: None, history=hist)

    queue = list(draws)

    def fake(key, shape=(), dtype=jnp.float32, *a, **k):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return jnp.asarray(arr, dtype)

    monkeypatch.setattr(jax.random, "uniform", fake)
    monkeypatch.setattr(jax.random, "normal", fake)
    # the JAX loop's step unjitted, so that every step takes the next draws
    # (a jitted step would keep the first step's as constants)
    jexp._train_step = make_jax_step(
        jexp.train_model, jexp.tx, sigma_min=jc.dynamic.sigma_min,
        ema_rate=jc.train.ema_rate, lr_schedule=jexp.lr_schedule,
        latents_from_moments=jc.train.from_moments,
        vae_scale=jc.autoencoder.scale_factor)
    jstate = jloop._train_body(jexp, jc)
    jl = [json.loads(line)["loss"] for line in
          open(tmp_path / "jax" / "metrics.jsonl") if "loss" in line]
    np.testing.assert_allclose([h["loss"] for h in hist], jl, atol=1e-5)
    ref = uvit_flax_to_torch(jax.tree.map(np.asarray, jstate.params))
    for k, v in out["state"].params.items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k], atol=1e-4,
                                   err_msg=k)
