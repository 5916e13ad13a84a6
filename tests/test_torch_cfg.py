"""Classifier-free guidance and the conditional modes of the port held to
the JAX package on the CPU: the ``synthetic_t2i`` and ``synthetic_class``
datasets and ``CFGDataset`` (bit for bit for the same seed and epoch), the
conditional toy configs and U-ViT-T2I-large's config key for key,
``cfg_velocity_fn`` (f32 1e-5), the null and evaluation conditioning, the
train step in the ``cond`` and ``t2i`` modes for 3 steps on the same draws
(1e-4, ``tests/test_torch_train.py``'s rule), ``cli/train_lfm`` feeding the
JAX loop's conditional batches, and ``cli/sample_lfm`` with guidance.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.configs import (
    lfm_mscoco_uvit_from_in256,
    lfm_mscoco_uvit_small_deep16_v2,
    synthetic_cond_e2e,
    synthetic_t2i_e2e,
    synthetic_t2i_unet_e2e,
)
from uspace_tpu.data.datasets import get_dataset as jax_get_dataset
from uspace_tpu.data.loader import DataLoader as JaxLoader
from uspace_tpu.evals.sampling import cfg_velocity_fn as jax_cfg_vf
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.models.uvit_t2i import UViTT2I as JaxUViTT2I
from uspace_tpu.train import loop as jloop
from uspace_tpu.train import state as jstate
from uspace_tpu.train import step as jstep
from uspace_tpu_torch.cli import sample_lfm, train_lfm
from uspace_tpu_torch.codecs.convert import (
    load_uvit_from_jax,
    load_uvit_t2i_from_jax,
    uvit_flax_to_torch,
)
from uspace_tpu_torch.configs import get_config, per_card
from uspace_tpu_torch.data.datasets import get_dataset
from uspace_tpu_torch.evals import sampling
from uspace_tpu_torch.models import UViT, UViTT2I
from uspace_tpu_torch.train import state as tstate
from uspace_tpu_torch.train import step as tstep

JAX_TOYS = {"synthetic_cond_e2e": synthetic_cond_e2e,
            "synthetic_t2i_e2e": synthetic_t2i_e2e,
            "synthetic_t2i_unet_e2e": synthetic_t2i_unet_e2e}
COND = dict(img_size=4, patch_size=2, in_chans=4, embed_dim=64, depth=2,
            num_heads=2, num_classes=5)
T2I = dict(img_size=4, patch_size=2, in_chans=4, embed_dim=64, depth=2,
           num_heads=2, clip_dim=16, num_clip_token=6)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# data and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("synthetic_t2i", dict(num=40, shape=(4, 4, 8), vocab=5, num_tokens=6,
                           ctx_dim=16, amp=5.0, cfg=True, p_uncond=0.3)),
    ("synthetic_t2i", dict(num=16, shape=(8, 8, 8))),
    ("synthetic_class", dict(num=40, shape=(4, 4, 8), num_classes=4,
                             amp=5.0, cfg=True, p_uncond=0.3)),
    ("synthetic_class", dict(num=16)),
])
def test_conditional_datasets_are_the_jax_ones(name, kw):
    """Each split sample for sample, at epochs 0 and 3, the CFG wrapper
    dropping the same indices; the factory's K, null label and empty
    context."""
    mine, ref = get_dataset(name, **kw), jax_get_dataset(name=name, **kw)
    for split in ("train", "test"):
        a, b = mine.get_split(split), ref.get_split(split)
        assert len(a) == len(b)
        for epoch in (0, 3):
            for ds in (a, b):
                if hasattr(ds, "set_epoch"):
                    ds.set_epoch(epoch)
            for i in range(len(a)):
                _same(a[i], b[i])
    for attr in ("K", "null_label", "has_label"):
        assert getattr(mine, attr, None) == getattr(ref, attr, None), attr
    if name == "synthetic_t2i":
        np.testing.assert_array_equal(mine.empty_context, ref.empty_context)
    if kw.get("cfg"):  # the drop happens, on a set that moves with epoch
        key = "context" if name == "synthetic_t2i" else "y"
        dropped = []
        for epoch in (0, 1):
            mine.train.set_epoch(epoch)
            base = mine.train.dataset
            dropped.append({i for i in range(len(base)) if not np.array_equal(
                mine.train[i][key], base[i][key])})
        assert dropped[0] and dropped[0] != dropped[1]


def _plain(v):
    if hasattr(v, "to_dict"):
        v = v.to_dict()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("name", sorted(JAX_TOYS))
def test_conditional_toy_configs_are_the_jax_configs(name):
    """nnet, dataset, train, dissection (with its token_kwargs), optimizer,
    schedule and solver blocks, seed and latent shape key for key (the
    tap None there is "mid" here); sample_steps, batch and cfg_scale."""
    mine, ref = _plain(get_config(name)), _plain(JAX_TOYS[name].get_config())
    for k in ("seed", "z_shape", "compute_dtype"):
        assert mine[k] == ref[k], k
    for blk in ("nnet", "dataset", "train", "dissection", "optimizer",
                "lr_scheduler", "dynamic"):
        a, b = mine[blk], ref[blk]
        port_only = {"quant"} if (blk == "nnet" and a["name"] != "unet_t2i") \
            else set()
        assert set(a) - set(b) == port_only, blk
        assert set(b) - set(a) == set(), blk
        for key in set(a) & set(b):
            want = b[key]
            if (blk, key) == ("dissection", "edit_loc"):
                want = want or "mid"
            assert a[key] == want, (blk, key)
    for key in ("sample_steps", "mini_batch_size", "cfg_scale",
                "solver_kwargs"):
        assert mine["sample"][key] == ref["sample"][key], key


@pytest.mark.parametrize("name,ref", [
    ("uvit_t2i_large", lfm_mscoco_uvit_from_in256),
    ("uvit_t2i_small_deep16", lfm_mscoco_uvit_small_deep16_v2)])
def test_t2i_large_configs_are_the_jax_configs(name, ref):
    """The field, the training and the optimizer blocks of the MS-COCO T2I
    configs, the batch one card's of the JAX global batch (the configs'
    batch rule); the dataset is synthetic_t2i at the features' shapes (L =
    1 + 77 + 256 = 334) with the config's cfg and p_uncond (no dropout)."""
    mine, ref = _plain(get_config(name)), _plain(ref.get_config())
    assert mine["nnet"] == {**ref["nnet"], "quant": False}
    assert mine["seed"] == ref["seed"] and mine["z_shape"] == ref["z_shape"]
    for key in ("n_steps", "mode", "log_interval", "eval_interval",
                "save_interval", "ema_rate", "grad_clip"):
        assert mine["train"][key] == ref["train"][key], key
    assert mine["train"]["batch_size"] == per_card(ref["train"]["batch_size"])
    assert mine["optimizer"] == ref["optimizer"]
    d = mine["dataset"]
    assert (d["name"], d["shape"], d["num_tokens"], d["ctx_dim"], d["cfg"],
            d["p_uncond"]) == ("synthetic_t2i", (32, 32, 8), 77, 768,
                               ref["dataset"]["cfg"],
                               ref["dataset"]["p_uncond"])
    m = UViTT2I(**{k: v for k, v in mine["nnet"].items() if k != "name"},
                device="meta")
    assert m.pos_embed.shape == (1, 334, mine["nnet"]["embed_dim"])


@pytest.mark.parametrize("name", sorted(JAX_TOYS))
def test_train_lfm_feeds_the_jax_loops_conditional_batches(
        monkeypatch, tmp_path, name):
    """``train_lfm.run`` feeds its step the JAX loop's batches for the
    config's seed: moments, and the labels or contexts with their CFG
    drop."""
    fed = []

    def fake_step(model, tx, **kw):
        def step(state, batch, gen):
            fed.append({k: v.numpy().copy() for k, v in batch.items()})
            z = torch.zeros(())
            return dict(loss=z, grad_norm=z, lr=z, nonfinite_skip=z)
        return step

    monkeypatch.setattr(train_lfm, "make_train_step", fake_step)
    monkeypatch.setattr(train_lfm.checkpoint, "save",
                        lambda root, state: str(tmp_path / "ck.pt"))
    monkeypatch.setattr(train_lfm, "build_train_model",
                        lambda *a, **k: torch.nn.Linear(1, 1))
    cfg = get_config(name)
    train_lfm.run(cfg, n_steps=2, device="cpu", workdir=str(tmp_path),
                  log=lambda s: None)
    jcfg = JAX_TOYS[name].get_config()
    ref = JaxLoader(jax_get_dataset(**dict(jcfg.dataset)).get_split("train"),
                    jcfg.train.batch_size, seed=jcfg.seed,
                    num_workers=1).infinite(start_step=0)
    key = "y" if name == "synthetic_cond_e2e" else "context"
    for mine in fed:
        want = next(ref)
        assert set(mine) == {"x", key}
        np.testing.assert_array_equal(mine["x"], want["x"])
        np.testing.assert_array_equal(mine[key], want[key])


# ---------------------------------------------------------------------------
# guidance and conditioning
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toys():
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 4, 4, 4)).astype(np.float32)
    t = np.full((3,), 0.4, np.float32)
    y = np.array([0, 2, 3], np.int32)  # K = 4 real classes, null 4
    c = r.standard_normal((3, 6, 16)).astype(np.float32)
    pc = jax.tree.map(np.asarray, jax.jit(JaxUViT(**COND).init)(
        jax.random.PRNGKey(0), x, t, y))
    pt = jax.tree.map(np.asarray, jax.jit(JaxUViTT2I(**T2I).init)(
        jax.random.PRNGKey(1), x, t, c))
    return dict(x=x, t=t, y=y, c=c, cond=pc, t2i=pt)


def test_cfg_velocity_fn_matches_jax(toys):
    """v_u + s (v_c - v_u) from one forward over [cond ‖ uncond], for labels
    (null class K) and contexts (zeros), at s = 0, 1 and 3."""
    x, t = toys["x"], toys["t"]
    cases = (
        (JaxUViT(**COND), toys["cond"],
         load_uvit_from_jax(UViT(device="cpu", **COND), toys["cond"]),
         "y", toys["y"], np.full(3, 4, np.int32)),
        (JaxUViTT2I(**T2I), toys["t2i"],
         load_uvit_t2i_from_jax(UViTT2I(device="cpu", **T2I), toys["t2i"]),
         "context", toys["c"], np.zeros_like(toys["c"])))
    for jm, p, m, key, cval, nval in cases:
        jvf = jax.jit(lambda p_, c_, n_, s_, t_, x_, jm=jm, key=key:
                      jax_cfg_vf(jm, p_, {key: c_}, {key: n_}, s_)(t_, x_))
        for s in (0.0, 1.0, 3.0):
            ref = jvf(p, cval, nval, s, t, x)
            vf = sampling.cfg_velocity_fn(
                m, {key: torch.from_numpy(cval).long() if key == "y"
                    else torch.from_numpy(cval)},
                {key: torch.from_numpy(nval).long() if key == "y"
                 else torch.from_numpy(nval)}, s)
            with torch.no_grad():
                out = vf(torch.from_numpy(t), torch.from_numpy(x))
            _close(out, ref, 1e-5)


def test_cfg_velocity_fn_refuses_a_one_sided_key(toys):
    jm, p = JaxUViT(**COND), toys["cond"]
    y = jnp.asarray(toys["y"])
    with pytest.raises(ValueError, match="only one of"):
        jax_cfg_vf(jm, p, {"y": y}, {}, 2.0)(jnp.asarray(toys["t"]),
                                             jnp.asarray(toys["x"]))
    m = UViT(device="cpu", **COND)
    for cond, null in (({"y": torch.zeros(3, dtype=torch.long)}, {}),
                       ({}, {"context": torch.zeros(3, 6, 16)})):
        with pytest.raises(ValueError, match="only one of"):
            sampling.cfg_velocity_fn(m, cond, null, 2.0)(
                torch.zeros(3), torch.zeros(3, 4, 4, 4))


@pytest.mark.parametrize("name,kw", [
    ("synthetic_class", dict(num=16, num_classes=4, cfg=True, p_uncond=0.1)),
    ("synthetic_class", dict(num=16, num_classes=4)),
    ("synthetic_t2i", dict(num=16, shape=(4, 4, 8), num_tokens=6,
                           ctx_dim=16)),
    ("synthetic", dict(num=16, shape=(4, 4, 8), num_classes=3))])
def test_null_and_eval_cond_are_the_jax_loops(name, kw):
    """null_cond is the JAX loop's (the learned null class K, never K - 1;
    the empty context); eval_cond draws the mode's conditioning."""
    ds, jds = get_dataset(name, **kw), jax_get_dataset(name=name, **kw)
    fake = types.SimpleNamespace(dataset=jds)
    y = np.array([0, 1, 2], np.int32)
    c = np.ones((3, 6, 16), np.float32)
    for cond in ({"y": y}, {"context": c}, {"y": y, "context": c}):
        ref = jloop.Experiment.null_cond(
            fake, {k: jnp.asarray(v) for k, v in cond.items()})
        mine = sampling.null_cond(ds, {k: torch.from_numpy(v)
                                       for k, v in cond.items()})
        assert mine.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    g = torch.Generator().manual_seed(0)
    mode = "t2i" if name == "synthetic_t2i" else "cond"
    ec = sampling.eval_cond(mode, ds, 5, g)
    if name == "synthetic_t2i":
        assert ec["context"].shape == (5, 6, 16)
        test = ds.get_split("test")
        rows = {test[i]["context"].tobytes() for i in range(len(test))}
        assert all(c_.numpy().tobytes() in rows for c_ in ec["context"])
    else:
        assert ec["y"].shape == (5,) and int(ec["y"].max()) < ds.K
    assert sampling.eval_cond("uncond", get_dataset("synthetic", num=4), 5,
                              g) == {}


# ---------------------------------------------------------------------------
# the train step in the conditional modes
# ---------------------------------------------------------------------------


def _jit_with_draws(monkeypatch, step_j):
    """JAX's train step jitted once, its ``jax.random.uniform``/``normal``
    draws (moments noise, t, path noise, in call order) taken from the
    jitted function's arguments, so every call runs the port's draws."""
    held = []

    def fake(key, shape=(), dtype=jnp.float32, *args, **kw):
        arr = held.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return arr.astype(dtype)

    monkeypatch.setattr(jax.random, "uniform", fake)
    monkeypatch.setattr(jax.random, "normal", fake)

    @jax.jit
    def run(state, batch, *draws):
        held[:] = list(draws)
        return step_j(state, batch, jax.random.PRNGKey(0))

    return run


@pytest.mark.parametrize("mode", ["cond", "t2i"])
def test_conditional_train_steps_match_jax(toys, monkeypatch, mode):
    """Three train steps (moments, CFM loss with the batch's labels or
    contexts, grads, Adam with a warmup, EMA) against JAX's step on the
    same draws and batches, then the whole state."""
    jm = (JaxUViT(attn_impl="pallas_packed", **COND) if mode == "cond"
          else JaxUViTT2I(attn_impl="pallas_packed", **T2I))
    jp = toys["cond" if mode == "cond" else "t2i"]
    lr_j = jstate.get_lr_schedule("customized", 1e-3, warmup_steps=2)
    tx_j = jstate.get_optimizer("adam", lr_j, weight_decay=0.03)
    state_j = jstate.TrainState.create(jax.tree.map(jnp.asarray, jp), tx_j)
    step_j = jstep.make_train_step(jm, tx_j, lr_schedule=lr_j, ema_rate=0.9,
                                   latents_from_moments=True)
    model = (load_uvit_from_jax(UViT(attn_impl="pallas_packed", device="cpu",
                                     **COND), jp) if mode == "cond"
             else load_uvit_t2i_from_jax(UViTT2I(attn_impl="pallas_packed",
                                                 device="cpu", **T2I), jp))
    lr = tstate.get_lr_schedule("customized", 1e-3, warmup_steps=2)
    tx = tstate.get_optimizer("adam", lr, weight_decay=0.03)
    state = tstate.TrainState.create(dict(model.named_parameters()), tx)
    step = tstep.make_train_step(model, tx, lr_schedule=lr, ema_rate=0.9,
                                 latents_from_moments=True)
    gen = torch.Generator().manual_seed(5)
    g = torch.Generator().set_state(gen.get_state())
    jstep_ = _jit_with_draws(monkeypatch, step_j)
    r = np.random.default_rng(6)
    for i in range(3):
        mom = r.standard_normal((3, 4, 4, 8)).astype(np.float32)
        mom[..., 4:] = -3.0
        if mode == "cond":
            cval = r.integers(0, 5, 3).astype(np.int32)  # the null 4 too
            batch = {"x": torch.from_numpy(mom),
                     "y": torch.from_numpy(cval).long()}
            jbatch = {"x": jnp.asarray(mom), "y": jnp.asarray(cval)}
        else:
            cval = r.standard_normal((3, 6, 16)).astype(np.float32)
            batch = {"x": torch.from_numpy(mom),
                     "context": torch.from_numpy(cval)}
            jbatch = {"x": jnp.asarray(mom), "context": jnp.asarray(cval)}
        draws = (torch.randn((3, 4, 4, 4), generator=g).numpy(),
                 torch.rand((3,), generator=g).numpy(),
                 torch.randn((3, 4, 4, 4), generator=g).numpy())
        state_j, m_j = jstep_(state_j, jbatch, *draws)
        m = step(state, batch, gen)
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], m_j[k], 1e-4)
    for mine, ref in ((state.params, state_j.params),
                      (state.ema_params, state_j.ema_params)):
        ref = uvit_flax_to_torch(ref)
        assert mine.keys() == ref.keys()
        for k in mine:
            _close(mine[k], ref[k], 1e-4)


# ---------------------------------------------------------------------------
# the sampling entry point
# ---------------------------------------------------------------------------


def _tiny(name):
    cfg = get_config(name)
    cfg["compute_dtype"] = "float32"
    cfg["nnet"].update(embed_dim=32, depth=2, num_heads=2)
    cfg["dataset"]["num"] = 16
    return cfg


def test_sample_lfm_guides_conditional_configs(tmp_path):
    """sample_lfm on the T2I and class toys: finite latents; guidance at
    s = 1 equals the conditional field's decode of the same noise and
    contexts (v_u + 1 (v_c - v_u) = v_c to rounding), s = 3 moves them;
    the stage-delta field refuses conditioning."""
    for name in ("synthetic_t2i_e2e", "synthetic_cond_e2e"):
        cfg = _tiny(name)
        outs = {}
        for s in (0.0, 1.0, 3.0):
            p = sample_lfm.run(cfg, n_samples=3, batch=3, steps=2,
                               device="cpu", out=str(tmp_path / f"{s}"),
                               cfg_scale=s)
            outs[s] = np.load(p[0])
            assert outs[s].shape == (3, 4, 4, 4)
            assert np.isfinite(outs[s]).all()
        np.testing.assert_allclose(outs[1.0], outs[0.0], atol=1e-5)
        assert np.abs(outs[3.0] - outs[1.0]).max() > 1e-4
        with pytest.raises(NotImplementedError, match="uncond-only"):
            sample_lfm.run(cfg, n_samples=2, batch=2, device="cpu",
                           out=str(tmp_path / "d"), solver="adaptive",
                           field="stage_delta_int8")


def test_sample2dir_writes_the_jax_layout(tmp_path):
    """``sample2dir`` writes ``{i}.png`` a sample (unpreprocessed from
    [-1, 1]), or one ``{first index}.npy`` a mini-batch, as JAX's."""
    from uspace_tpu_torch.data.datasets import unpreprocess

    calls = []

    def sample_fn(gen, n):
        calls.append(n)
        return torch.rand((n, 4, 4, 3), generator=gen) * 2 - 1

    g = torch.Generator().manual_seed(0)
    sampling.sample2dir(sample_fn, 5, 2, str(tmp_path / "png"), g,
                        unpreprocess=unpreprocess)
    assert calls == [2, 2, 1]
    assert sorted(p.name for p in (tmp_path / "png").iterdir()) == [
        f"{i}.png" for i in range(5)]
    sampling.sample2dir(sample_fn, 3, 2, str(tmp_path / "npy"), g,
                        as_npy=True)
    assert sorted(p.name for p in (tmp_path / "npy").iterdir()) == [
        "0.npy", "2.npy"]
    assert np.load(tmp_path / "npy" / "2.npy").shape == (1, 4, 4, 3)
