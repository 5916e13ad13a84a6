"""uspace_tpu_torch training path held to the JAX package on the CPU.

A toy U-ViT (embed 128, depth 2, 2 heads of 64, 8x8 latents: L = 17) is
initialised in JAX and carried across with ``load_uvit_from_jax``
(``strict=True``). jax.random streams cannot be reproduced in torch, so the
port draws its noise from a ``torch.Generator`` and the JAX side gets the
same draws: ``jax.random.uniform``/``normal`` are patched to hand them out
in call order (moments noise, t, path noise), and JAX's own functions run
unchanged. The Pallas kernels run in interpret mode.

Tolerances: f32 1e-5 for the interpolant ops (identical arithmetic), 1e-4
for the field, its loss and its gradients (a few dozen matmuls summed in
another order), bf16 2e-2 relative to the largest gradient entry (bf16
roundings of O(1) activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.core import interpolant as jinterp
from uspace_tpu.data.datasets import SyntheticFeatures as JaxSynthetic
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.train import state as jstate
from uspace_tpu.train import step as jstep
from uspace_tpu_torch.cli import train_lfm
from uspace_tpu_torch.codecs.convert import load_uvit_from_jax, uvit_flax_to_torch
from uspace_tpu_torch.core import flow, interpolant
from uspace_tpu_torch.data.datasets import SyntheticFeatures
from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.models.uvit import remat_exempt_set
from uspace_tpu_torch.train import checkpoint
from uspace_tpu_torch.train import state as tstate
from uspace_tpu_torch.train import step as tstep

CFG = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=128, depth=2,
           num_heads=2)
B = 3
SIGMA = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((B, 8, 8, 4))
    p = jax.jit(JaxUViT(**CFG).init)(jax.random.PRNGKey(0), x, jnp.zeros(B))
    return jax.tree.map(np.asarray, p)


def _port(params, dtype=torch.float32, attn_impl="pallas_packed", **kw):
    m = UViT(dtype=dtype, param_dtype=torch.float32, attn_impl=attn_impl,
             device="cpu", **CFG, **kw)
    return load_uvit_from_jax(m, params)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=tol)


def _inject(monkeypatch, draws):
    """Patch jax.random.uniform/normal to return ``draws`` in call order."""
    queue = [np.asarray(d) for d in draws]

    def fake(key, shape=(), dtype=jnp.float32, *args, **kw):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return jnp.asarray(arr, dtype)

    monkeypatch.setattr(jax.random, "uniform", fake)
    monkeypatch.setattr(jax.random, "normal", fake)
    return queue


def _draws(gen, x_shape, steps=1, moments=True):
    """The port's draws, in its order, from a copy of ``gen``."""
    g = torch.Generator().set_state(gen.get_state())
    out = []
    for _ in range(steps):
        if moments:
            out.append(torch.randn(x_shape, generator=g).numpy())
        out.append(torch.rand((x_shape[0],), generator=g).numpy())
        out.append(torch.randn(x_shape, generator=g).numpy())
    return out


def _moments(seed=0):
    r = np.random.default_rng(seed)
    mom = r.standard_normal((B, 8, 8, 8)).astype(np.float32)
    mom[..., 4:] = -2.0 + 0.5 * mom[..., 4:]  # logvar
    return mom


def test_interpolant_ops_match_jax():
    r = np.random.default_rng(1)
    x1, eps = (r.standard_normal((B, 8, 8, 4)).astype(np.float32)
               for _ in range(2))
    t = r.random(B).astype(np.float32)
    v = r.standard_normal((B, 8, 8, 4)).astype(np.float32)
    tx = [torch.from_numpy(a) for a in (x1, eps, t, v)]
    jx = [jnp.asarray(a) for a in (x1, eps, t, v)]
    _close(interpolant.interpolate(tx[0], tx[1], tx[2], SIGMA),
           jinterp.interpolate(jx[0], jx[1], jx[2], SIGMA), 1e-5)
    _close(interpolant.target_velocity(tx[0], tx[1], SIGMA),
           jinterp.target_velocity(jx[0], jx[1], SIGMA), 1e-5)
    loss = interpolant.cfm_loss(tx[3].bfloat16(), tx[0])
    assert loss.dtype == torch.float32 and loss.shape == (B,)
    _close(loss, jinterp.cfm_loss(jx[3].astype(jnp.bfloat16), jx[0]), 1e-5)


def test_sample_path_and_moments_match_jax(monkeypatch):
    """sample_path and sample_from_moments with the same draws; the port
    draws the moments noise, then t, then eps."""
    mom = _moments(2)
    gen = torch.Generator().manual_seed(3)
    _inject(monkeypatch, _draws(gen, (B, 8, 8, 4)))
    key = jax.random.PRNGKey(0)  # its bits are not used: draws are patched
    ref_x1 = jstep.sample_from_moments(jnp.asarray(mom), key)
    ref_t, ref_xt, ref_ut = jinterp.sample_path(key, ref_x1, SIGMA)
    x1 = tstep.sample_from_moments(torch.from_numpy(mom), gen)
    t, xt, ut = interpolant.sample_path(x1, SIGMA, gen)
    for a, b in ((x1, ref_x1), (t, ref_t), (xt, ref_xt), (ut, ref_ut)):
        _close(a, b, 1e-5)
    # logvar is clipped to [-30, 20] before the exp
    mom[0, 0, 0, 4:] = 100.0
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(tstep.sample_from_moments(torch.from_numpy(mom),
                                                    g)).all()


@pytest.mark.parametrize("attn_impl,dtype,tol", [
    ("pallas_packed", torch.float32, 1e-4),
    ("pallas_packed", torch.bfloat16, 2e-2),
    ("pallas_qkvproj", torch.float32, 1e-4),
])
def test_uvit_loss_and_grads_match_jax(jax_params, attn_impl, dtype, tol):
    """The CFM loss and every parameter gradient of the toy field (f32
    masters, compute in ``dtype``) vs jax.value_and_grad."""
    r = np.random.default_rng(4)
    xt = r.standard_normal((B, 8, 8, 4)).astype(np.float32)
    ut = r.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = r.random(B).astype(np.float32)
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JaxUViT(dtype=jd, attn_impl=attn_impl, **CFG)

    def jloss(p):
        v, _ = jm.apply(p, jnp.asarray(xt), jnp.asarray(t))
        return jinterp.cfm_loss(v, jnp.asarray(ut)).mean()

    ref_loss, ref_g = jax.value_and_grad(jloss)(jax_params)
    ref_g = uvit_flax_to_torch(ref_g)
    model = _port(jax_params, dtype, attn_impl)
    v, _ = model(torch.from_numpy(xt), torch.from_numpy(t))
    assert v.dtype == dtype
    loss = interpolant.cfm_loss(v, torch.from_numpy(ut)).mean()
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert set(names) == set(ref_g)
    _close(loss, ref_loss, tol)
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32, name  # reaches the f32 master
        scale = 1.0 if dtype == torch.float32 else max(
            1.0, float(np.abs(ref_g[name]).max()))
        _close(g, ref_g[name], tol * scale)


@pytest.mark.parametrize("mode", ["adam", "adamw"])
def test_train_steps_match_jax(jax_params, monkeypatch, mode):
    """Two full train steps (moments resampling, CFM loss, grads, global
    norm, fused Adam + EMA with a 2-step warmup) vs the JAX train step
    with FusedAdam, on the same draws; then the resulting state."""
    lr_j = jstate.get_lr_schedule("customized", 1e-3, warmup_steps=2)
    tx_j = jstate.get_optimizer(mode, lr_j, betas=(0.9, 0.99),
                                weight_decay=0.03)
    state_j = jstate.TrainState.create(
        jax.tree.map(jnp.asarray, jax_params), tx_j)
    step_j = jstep.make_train_step(JaxUViT(attn_impl="pallas_packed", **CFG),
                                   tx_j, lr_schedule=lr_j, ema_rate=0.9,
                                   latents_from_moments=True)
    lr = tstate.get_lr_schedule("customized", 1e-3, warmup_steps=2)
    tx = tstate.get_optimizer(mode, lr, betas=(0.9, 0.99), weight_decay=0.03)
    model = _port(jax_params)
    state = tstate.TrainState.create(dict(model.named_parameters()), tx)
    step = tstep.make_train_step(model, tx, lr_schedule=lr, ema_rate=0.9,
                                 latents_from_moments=True)
    gen = torch.Generator().manual_seed(5)
    _inject(monkeypatch, _draws(gen, (B, 8, 8, 4), steps=2))
    mom = _moments(6)
    for _ in range(2):
        state_j, m_j = step_j(state_j, {"x": jnp.asarray(mom)},
                              jax.random.PRNGKey(0))
        m = step(state, {"x": torch.from_numpy(mom)}, gen)
        for k in ("loss", "grad_norm", "lr", "nonfinite_skip"):
            _close(m[k], m_j[k], 1e-4)
    assert int(state.step) == int(state_j.step) == 2
    adam_j = [s for s in state_j.opt_state
              if hasattr(s, "mu") and hasattr(s, "nu")][0]
    assert int(state.opt_state.count) == int(adam_j.count) == 2
    for mine, ref in ((state.params, state_j.params),
                      (state.ema_params, state_j.ema_params),
                      (state.opt_state.mu, adam_j.mu),
                      (state.opt_state.nu, adam_j.nu)):
        ref = uvit_flax_to_torch(ref)
        assert mine.keys() == ref.keys()
        for k in mine:
            _close(mine[k], ref[k], 1e-4)


def test_lr_schedules_and_ema_match_jax():
    steps = np.array([0, 1, 7, 50, 99, 100, 5000], np.int32)
    for name, kw in (("customized", dict(warmup_steps=100)),
                     ("customized", {}),
                     ("cosine", dict(total_steps=1000))):
        ours = tstate.get_lr_schedule(name, 2e-4, **kw)
        ref = jstate.get_lr_schedule(name, 2e-4, **kw)
        for s in steps:
            _close(ours(torch.tensor(s)), ref(jnp.asarray(s)), 1e-10)
    r = np.random.default_rng(7)
    p, e = ({"w": r.standard_normal((4, 5)).astype(np.float32)}
            for _ in range(2))
    ema = {"w": torch.from_numpy(e["w"].copy())}
    tstate.ema_update({"w": torch.from_numpy(p["w"])}, ema, 0.995)
    _close(ema["w"], jstate.ema_update(p, e, 0.995)["w"], 1e-6)
    with pytest.raises(NotImplementedError):
        tstate.get_optimizer("sgd")


@pytest.mark.parametrize("exempt", [0, 2, 3])
def test_remat_exempt_leaves_values_and_grads_unchanged(jax_params, exempt):
    """use_checkpoint with 0, 2 or all 3 blocks exempt gives exactly the
    values and gradients of the model without checkpointing."""
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.standard_normal((B, 8, 8, 4)).astype(np.float32))
    t = torch.from_numpy(r.random(B).astype(np.float32))
    out = {}
    for key, kw in (("plain", {}), ("remat", dict(use_checkpoint=True,
                                                   remat_exempt=exempt))):
        model = _port(jax_params, **kw)
        v, _ = model(x, t)
        grads = torch.autograd.grad(v.square().mean(),
                                    list(model.parameters()))
        out[key] = [v] + list(grads)
    assert sum(model.remat) == 3 - exempt
    for a, b in zip(out["plain"], out["remat"]):
        assert torch.equal(a, b)


def test_remat_exempt_set_matches_jax_formula():
    for depth in (2, 4, 20):
        total = depth + 1
        for k in range(0, total + 3):
            kk = min(k, total)
            ref = {int(j * total / kk) for j in range(kk)} if kk else set()
            assert remat_exempt_set(depth, k) == ref
    assert remat_exempt_set(20, 12) == {0, 1, 3, 5, 7, 8, 10, 12, 14, 15, 17,
                                        19}


def test_nonfinite_guard_keeps_state_and_advances_step(jax_params):
    lr = tstate.get_lr_schedule("customized", 1e-3)
    tx = tstate.get_optimizer("adam", lr, weight_decay=0.03)
    model = _port(jax_params)
    state = tstate.TrainState.create(dict(model.named_parameters()), tx)
    step = tstep.make_train_step(model, tx, lr_schedule=lr,
                                 latents_from_moments=True)
    gen = torch.Generator().manual_seed(9)
    good = torch.from_numpy(_moments(10))
    step(state, {"x": good}, gen)
    before = {k: v.clone() for k, v in state.state_dict()["params"].items()}
    snap = [{k: v.clone() for k, v in d.items()}
            for d in (state.ema_params, state.opt_state.mu,
                      state.opt_state.nu)]
    bad = good.clone()
    bad[1, 2, 3, 0] = float("nan")
    m = step(state, {"x": bad}, gen)
    assert float(m["nonfinite_skip"]) == 1.0
    assert not np.isfinite(float(m["loss"]))
    assert int(state.step) == 2 and int(state.opt_state.count) == 1
    for k, v in before.items():
        assert torch.equal(state.params[k], v), k
    for d, s in zip((state.ema_params, state.opt_state.mu,
                     state.opt_state.nu), snap):
        for k in d:
            assert torch.equal(d[k], s[k]), k
    m = step(state, {"x": good}, gen)
    assert float(m["nonfinite_skip"]) == 0.0
    assert int(state.step) == 3 and int(state.opt_state.count) == 2


def test_synthetic_features_match_jax():
    for kw in (dict(num=5), dict(num=4, shape=(8, 8, 8), num_classes=7,
                                 context_shape=(3, 16), seed=11)):
        ours, ref = SyntheticFeatures(**kw), JaxSynthetic(**kw)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        batch = ours.batch([2, 0])
        np.testing.assert_array_equal(batch["x"][1], ref[0]["x"])


def test_train_cli_checkpoint_reloads(tmp_path):
    """cli.train_lfm on the CPU smoke config: finite losses, a checkpoint
    whose params load strictly into a fresh model and whose whole state
    restores into a fresh TrainState."""
    logs = []
    out = train_lfm.run("synthetic_smoke", n_steps=2, device="cpu",
                        workdir=str(tmp_path), log=logs.append)
    assert len(out["history"]) == 2 and len(logs) == 3
    assert all(np.isfinite(h["loss"]) and h["nonfinite_skip"] == 0
               for h in out["history"])
    assert out["checkpoint"] == str(tmp_path / "ckpts" / "2.pt")
    sd = checkpoint.load(out["checkpoint"])
    cfg = train_lfm.get_config("synthetic_smoke")
    fresh = train_lfm.build_train_model(cfg, torch.device("cpu"), seed=1)
    fresh.load_state_dict(sd["params"], strict=True)
    tx, _ = train_lfm.build_optimizer(cfg)
    state = tstate.TrainState.create(dict(fresh.named_parameters()), tx)
    checkpoint.restore(out["checkpoint"], state)
    assert int(state.step) == 2 and int(state.opt_state.count) == 2
    for k, v in out["state"].ema_params.items():
        assert torch.equal(state.ema_params[k], v)
    sd["params"].pop("pos_embed")
    with pytest.raises(KeyError, match="pos_embed"):
        state.load_state_dict(sd)


def test_sample_fn_decodes_seeded_noise(jax_params):
    model = _port(jax_params)
    sample = tstep.make_sample_fn(model, (8, 8, 4), sample_steps=3)
    gen = torch.Generator().manual_seed(12)
    z = torch.randn((2, 8, 8, 4), generator=torch.Generator().set_state(
        gen.get_state()))
    out = sample(gen, 2)
    with torch.no_grad():
        ref = flow.decode(lambda t, x: model(x, t)[0], z,
                          {"solver": "fixed", "solver_fix": "euler",
                           "solver_fix_step": 1 / 3})
    assert out.shape == (2, 8, 8, 4) and torch.equal(out, ref)


def test_f32_masters_compute_like_bf16_weights(jax_params):
    """param_dtype=f32 with bf16 compute gives bit for bit the output of a
    model whose weights are bf16 (the sampling path), and param_dtype
    defaults to dtype."""
    master = _port(jax_params, torch.bfloat16, "xla")
    plain = UViT(dtype=torch.bfloat16, attn_impl="xla", device="cpu", **CFG)
    assert plain.in_blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert plain.in_blocks[0].norm1.weight.dtype == torch.float32
    plain.load_state_dict(master.state_dict())
    assert master.pos_embed.dtype == torch.float32
    x = torch.randn(B, 8, 8, 4, generator=torch.Generator().manual_seed(13))
    t = torch.full((B,), 0.4)
    with torch.no_grad():
        assert torch.equal(master(x, t)[0], plain(x, t)[0])
