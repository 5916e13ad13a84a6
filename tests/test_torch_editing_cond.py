"""The port's conditional harnesses held to the JAX harnesses on the CPU,
and the port's training of the editing toys held to the JAX loop's, part
by part.

``cli/editing_e2e_cond`` and ``cli/editing_e2e_t2i`` are fed the JAX
harness's noise (``normal(PRNGKey(seed))``) and run on the same weights
(a toy initialised in JAX, carried across as a checkpoint of this port):
every figure of the two reports agrees (f32, Euler-4; rtol 1e-3 and atol
1e-4 on projections of O(1)), and so do the verdicts. The JAX package's
CPU proofs on trained weights are kept as ``slow`` tests.

The training parts (Queue 3's UNet-toy item): the initialisation of the
``synthetic_attr_unet_e2e`` UNet leaf by leaf against Flax's (the same
leaves zero, each other leaf's std within 5 standard errors of Flax's
draw), the training draws of t, the path noise and the moments noise
against ``jax.random``'s (two-sample Kolmogorov-Smirnov at 1e-3), and the
optimizer, schedule, EMA and clipping the loop builds from the config.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.cli import dissect_common as jax_dissect_common
from uspace_tpu.cli import editing_e2e_cond as jax_cond
from uspace_tpu.cli import editing_e2e_t2i as jax_t2i
from uspace_tpu.configs import synthetic_attr_unet_e2e as jax_unet_toy
from uspace_tpu.configs import synthetic_cond_e2e as jax_cond_toy
from uspace_tpu.configs import synthetic_t2i_e2e as jax_t2i_toy
from uspace_tpu.configs.common import nnet_kwargs
from uspace_tpu.models import get_nnet as jax_get_nnet
from uspace_tpu.train import state as jstate
from uspace_tpu_torch.cli import editing_e2e_cond, editing_e2e_t2i, train_lfm
from uspace_tpu_torch.codecs.convert import unet_flax_to_torch, uvit_flax_to_torch
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.core import interpolant
from uspace_tpu_torch.train import step as tstep


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(embed_dim=64, depth=2, num_heads=2)


def _jax_and_port_configs(jax_module, name, nnet, dataset):
    jcfg = jax_module.get_config()
    jcfg.compute_dtype = "float32"
    jcfg.nnet.update(nnet)
    jcfg.dataset.update(dataset)
    jcfg.dissection.mini_batch_size = 4
    jcfg.dissection.solver_kwargs.solver_fix_step = 0.25
    cfg = get_config(name)
    cfg["compute_dtype"] = "float32"
    cfg["nnet"].update(nnet)
    cfg["dataset"].update(dataset)
    cfg["dissection"]["mini_batch_size"] = 4
    cfg["dissection"]["solver_kwargs"]["solver_fix_step"] = 0.25
    return jcfg, cfg


def _same_weights(monkeypatch, tmp_path, jcfg, cfg, init_args):
    """Seeded JAX weights for the JAX harness and, as a checkpoint of this
    port, for the port's."""
    model = jax_get_nnet(jcfg.nnet.name, **nnet_kwargs(jcfg.nnet, "float32"))
    params = jax.jit(model.init)(jax.random.PRNGKey(3), *init_args)
    monkeypatch.setattr(jax_dissect_common, "load_nnet_params",
                        lambda c, m, a: params)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          uvit_flax_to_torch(jax.tree.map(np.asarray, params)).items()}
    path = tmp_path / "1.pt"
    torch.save({"ema_params": sd}, path)
    cfg["dissection"]["ckpt_path_to_dissect"] = str(path)


def _noise(jcfg):
    c, h, w = jcfg.z_shape
    n = min(int(jcfg.dissection.mini_batch_size), 32)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(jcfg.seed),
                                        (n, h, w, c)))


def _same_report(mine, ref):
    """Every number of the two reports (json-like trees) agrees."""
    if isinstance(ref, dict):
        assert set(mine) == set(ref)
        for k in ref:
            _same_report(mine[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            _same_report(a, b)
    elif isinstance(ref, (bool, str)) or ref is None:
        assert mine == ref
    else:
        np.testing.assert_allclose(mine, ref, rtol=1e-3, atol=1e-4)


def test_cond_harness_reads_the_jax_harness(monkeypatch, tmp_path):
    jcfg, cfg = _jax_and_port_configs(
        jax_cond_toy, "synthetic_cond_e2e", dict(SMALL, num_classes=3),
        dict(num_classes=2, num=64))
    _same_weights(monkeypatch, tmp_path, jcfg, cfg,
                  (jnp.zeros((1, 4, 4, 4)), jnp.zeros((1,)),
                   jnp.zeros((1,), jnp.int32)))
    ref = jax_cond.run(jcfg, str(tmp_path / "jax"))
    mine = editing_e2e_cond.run(cfg, str(tmp_path / "port"), device="cpu",
                                noise=_noise(jcfg), log=lambda s: None)
    _same_report(mine, ref)
    assert {"cond_grid.png", "editing_e2e_cond.json",
            "editing_e2e_cond.md"} <= {p.name for p in
                                       (tmp_path / "port").iterdir()}


def test_t2i_harness_reads_the_jax_harness(monkeypatch, tmp_path):
    jcfg, cfg = _jax_and_port_configs(
        jax_t2i_toy, "synthetic_t2i_e2e", SMALL, dict(num=64))
    _same_weights(monkeypatch, tmp_path, jcfg, cfg,
                  (jnp.zeros((1, 4, 4, 4)), jnp.zeros((1,)),
                   jnp.zeros((1, 8, 32))))
    ref = jax_t2i.run(jcfg, str(tmp_path / "jax"))
    mine = editing_e2e_t2i.run(cfg, str(tmp_path / "port"), device="cpu",
                               noise=_noise(jcfg), log=lambda s: None)
    _same_report(mine, ref)
    assert set(mine["checks"]) == {"conditioning", "p2p_rescale",
                                   "local_prompt", "cfg_guidance"}


# ---------------------------------------------------------------------------
# the training parts of the UNet toy
# ---------------------------------------------------------------------------


def test_unet_toy_init_matches_flax_leaf_by_leaf():
    """Every leaf of the toy UNet: the same zero leaves (the output convs,
    the biases), unit norm scales, and each drawn leaf's mean and std
    within 5 standard errors of Flax's draw of the same leaf."""
    jcfg = jax_unet_toy.get_config()
    model = jax_get_nnet(jcfg.nnet.name, **nnet_kwargs(jcfg.nnet, None))
    ref = unet_flax_to_torch(jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)))))
    cfg = get_config("synthetic_attr_unet_e2e")
    port = train_lfm.build_train_model(cfg, torch.device("cpu"), seed=0)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    assert sd.keys() == ref.keys()
    drawn = 0
    for k, a in sd.items():
        b = np.asarray(ref[k], np.float64)
        assert a.shape == b.shape, k
        if not b.any() or np.all(b == 1.0):
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        n = b.size
        se = b.std() / np.sqrt(n)
        assert abs(a.mean() - b.mean()) < 5 * se + 1e-7, k
        assert abs(a.std() / b.std() - 1) < 5 / np.sqrt(2 * n) + 0.02, k
        drawn += 1
    zero = [k for k, v in ref.items() if not np.asarray(v).any()]
    assert drawn > 20 and any(k.startswith("out.2") for k in zero)
    assert sum(".out_layers.3." in k for k in zero) >= 4


def _ks(a, b):
    """Two-sample Kolmogorov-Smirnov statistic."""
    a, b = np.sort(a.ravel()), np.sort(b.ravel())
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(fa - fb).max())


def test_training_draws_match_jax_distributions():
    """The port's step draws (moments noise, t, path noise from one torch
    generator) against the JAX step's (``jax.random``) for a batch of the
    toy's shape, over 40 steps: t uniform on [0, 1), the noises standard
    normal, the latents' spread from the moments the same."""
    n_steps, shape = 40, (256, 8, 8, 4)
    gen = torch.Generator().manual_seed(0)
    mom = np.zeros((256, 8, 8, 8), np.float32)
    mom[..., 4:] = 2.0 * np.log(0.05 / 0.18215)
    ts, eps, lat = [], [], []
    for _ in range(n_steps):
        x1 = tstep.sample_from_moments(torch.from_numpy(mom), gen)
        t, x_t, u_t = interpolant.sample_path(x1, 1e-4, gen)
        ts.append(t.numpy())
        eps.append(((x_t - t[:, None, None, None] * x1)
                    / (1 - (1 - 1e-4) * t[:, None, None, None])).numpy())
        lat.append(x1.numpy())
    key = jax.random.PRNGKey(0)
    jt = np.asarray(jax.random.uniform(key, (n_steps * 256,)))
    je = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                      (n_steps,) + shape))
    jl = np.asarray(jax.random.normal(jax.random.fold_in(key, 2),
                                      (n_steps,) + shape)) * 0.05
    crit = lambda n, m: 1.95 * np.sqrt((n + m) / (n * m))  # noqa: E731
    for mine, ref in ((np.concatenate(ts), jt),
                      (np.stack(eps)[:, :, 0], je[:, :, 0]),
                      (np.stack(lat)[:, :, 1], jl[:, :, 1])):
        sub = mine.ravel()[:200_000]
        ref = ref.ravel()[:200_000]
        assert _ks(sub, ref) < crit(sub.size, ref.size)
    assert 0.0 <= float(np.concatenate(ts).min()) and \
        float(np.concatenate(ts).max()) < 1.0


def test_training_optimizer_is_the_jax_loops():
    """The toy's optimizer, LR schedule, EMA rate and clipping as the JAX
    loop builds them from its config (Adam, no warmup, EMA 0.999, no
    clipping; the pixel toy clips at 1.0)."""
    for name, mod in (("synthetic_attr_unet_e2e", jax_unet_toy),):
        cfg, jcfg = get_config(name), mod.get_config()
        tx, lr = train_lfm.build_optimizer(cfg)
        jlr = jstate.get_lr_schedule(
            jcfg.lr_scheduler.name, jcfg.optimizer.lr,
            warmup_steps=jcfg.lr_scheduler.get("warmup_steps", 0),
            total_steps=jcfg.train.n_steps)
        gc = jcfg.train.get("grad_clip", -1.0)
        jtx = jstate.get_optimizer(jcfg.optimizer.name, jlr,
                                   betas=tuple(jcfg.optimizer.betas),
                                   weight_decay=jcfg.optimizer.weight_decay,
                                   grad_clip=gc if gc and gc > 0 else None)
        assert isinstance(jtx, jstate.FusedAdam) and tx.grad_clip is None
        assert (tx.mode, tx.b1, tx.b2, tx.eps, tx.weight_decay) == (
            jtx.mode, jtx.b1, jtx.b2, jtx.eps, jtx.weight_decay)
        for step in (0, 1, 100, 2999):
            assert float(lr(torch.tensor(step))) == pytest.approx(
                float(jlr(jnp.asarray(step))), rel=1e-7)
        assert cfg["train"]["ema_rate"] == jcfg.train.ema_rate == 0.999
    pixel = get_config("synthetic_attr_pixel_e2e")
    assert train_lfm.build_optimizer(pixel)[0].grad_clip == 1.0


# ---------------------------------------------------------------------------
# the JAX package's CPU proofs on trained weights
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_trained_cond_model_end_to_end(tmp_path):
    """tests/test_editing_e2e_cond.py:67's bar: embed 64, depth 4, four
    classes and the null class, 1500 steps at batch 64 in f32 with EMA
    0.99 and lr 8e-4, then the harness at 24 samples and Euler-10."""
    cfg = get_config("synthetic_cond_e2e")
    cfg["compute_dtype"] = "float32"
    cfg["train"].update(ema_rate=0.99, n_steps=1500, batch_size=64,
                        log_interval=500)
    cfg["optimizer"]["lr"] = 8e-4
    cfg["nnet"].update(embed_dim=64, depth=4, num_classes=5)
    cfg["dataset"].update(num=2048, num_classes=4)
    cfg["dissection"]["mini_batch_size"] = 24
    cfg["dissection"]["solver_kwargs"]["solver_fix_step"] = 0.1
    train_lfm.run(cfg, device="cpu", workdir=str(tmp_path / "train"),
                  log=lambda s: None)
    cfg["dissection"]["ckpt_path_to_dissect"] = str(tmp_path / "train" /
                                                    "ckpts")
    report = editing_e2e_cond.run(cfg, str(tmp_path / "e2e"), device="cpu")
    for r in report["checks"]["conditioning"]["rows"]:
        assert r["margin_sigma"] >= 2.0, r
        assert r["own_mean"] > r["other_mean"] + 0.5, r
    cg = report["checks"]["cfg_guidance"]
    assert abs(cg["margins"][0]) < 0.5 * cg["margins"][1], cg
    assert cg["margins"][2] >= 0.9 * cg["margins"][1], cg
    assert (tmp_path / "e2e" / "cond_grid.png").exists()


@pytest.mark.slow
def test_trained_t2i_editing_end_to_end(tmp_path):
    """tests/test_editing_e2e_t2i.py:73's bar: embed 64, depth 4, 6 context
    tokens of 16 over 4 words, 2500 steps at batch 64 in f32 with EMA 0.99
    and lr 8e-4, then the harness at 24 samples and Euler-10."""
    cfg = get_config("synthetic_t2i_e2e")
    cfg["compute_dtype"] = "float32"
    cfg["train"].update(ema_rate=0.99, n_steps=2500, batch_size=64,
                        log_interval=500)
    cfg["optimizer"]["lr"] = 8e-4
    cfg["nnet"].update(embed_dim=64, depth=4, num_clip_token=6, clip_dim=16)
    cfg["dataset"].update(num=2048, vocab=4, num_tokens=6, ctx_dim=16)
    cfg["dissection"]["mini_batch_size"] = 24
    cfg["dissection"]["solver_kwargs"]["solver_fix_step"] = 0.1
    train_lfm.run(cfg, device="cpu", workdir=str(tmp_path / "train"),
                  log=lambda s: None)
    cfg["dissection"]["ckpt_path_to_dissect"] = str(tmp_path / "train" /
                                                    "ckpts")
    report = editing_e2e_t2i.run(cfg, str(tmp_path / "e2e"), device="cpu")
    for r in report["checks"]["conditioning"]["rows"]:
        assert r["margin_sigma"] >= 2.0, r
        assert r["present_mean"] > r["absent_mean"] + 0.3, r
    p2p = report["checks"]["p2p_rescale"]
    assert p2p["monotone"], p2p
    assert p2p["target_drop_mult0"] > 0.15, p2p
    lp = report["checks"]["local_prompt"]
    assert lp["new_word_after"] > lp["new_word_before"] + 0.3, lp
    assert lp["old_word_before"] > lp["old_word_after"] + 0.3, lp
    cg = report["checks"]["cfg_guidance"]
    assert abs(cg["margins"][0]) < 0.5 * cg["margins"][1], cg
    assert cg["margins"][2] >= 0.9 * cg["margins"][1], cg
    assert (tmp_path / "e2e" / "t2i_sweeps.png").exists()
