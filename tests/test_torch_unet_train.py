"""uspace_tpu_torch SD-UNet training held to the JAX package.

The ``synthetic_unet`` toy UNet (f32, attention at 8 x 8) with its
zero-initialised output convs drawn live (``ZERO_INIT_STD``: with the
reference's zeros every gradient upstream of ``out.2`` is zero and a
comparison would hold nothing), one param tree given to both packages
through ``codecs/convert`` with ``strict=True``, and the port's torch draws
fed to JAX by patching ``jax.random.uniform/normal``. Two train steps with
attn_impl "pallas" (JAX interprets _fwd_kernel and _bwd_kernel; the port
runs kernel 7's and kernel 8's twins) and "auto" (plain math on both
sides): loss, grad_norm and Adam moments within 1e-4 of each tensor's
scale (f32 sums in another order through some 30 layers), params and EMA
within 2e-4 (``ADAM_TOL``). Also: per-block remat, the Flax LeCun init, grad_clip
against optax's chain, and the training entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from uspace_tpu.codecs.convert import unet_torch_to_flax
from uspace_tpu.models.unet import UNet as JaxUNet
from uspace_tpu.train import state as jstate
from uspace_tpu.train import step as jstep
from uspace_tpu_torch.cli import train_lfm
from uspace_tpu_torch.codecs.convert import load_unet_from_jax, unet_flax_to_torch
from uspace_tpu_torch.codecs.vae import AutoencoderKL
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.models import UNet, UViT
from uspace_tpu_torch.models.layers import TRUNC_NORMAL_STD, lecun_normal_
from uspace_tpu_torch.models.unet import ZERO_INIT_STD
from uspace_tpu_torch.train import checkpoint
from uspace_tpu_torch.train import state as tstate
from uspace_tpu_torch.train import step as tstep

# the synthetic_unet toy at 64 channels: at 32, GroupNorm's gcd(32, C)
# groups hold one channel each, so a conv bias in front of one is a
# per-channel shift that the norm removes, its exact gradient is zero, and
# Adam turns the two packages' different round-off into updates of +-lr
NNET = dict({k: v for k, v in get_config("synthetic_unet")["nnet"].items()
             if k != "name"}, model_channels=64)
B = 2
TOL = 1e-4
# params and EMA after Adam: each gradient element is divided by its own
# root mean square, so an element whose gradient cancels to a small value
# carries its relative round-off into the update at full size (a Downsample
# bias reads 1.03e-4 of its scale)
ADAM_TOL = 2e-4


def _port_unet(params=None, **kw):
    m = UNet(**dict(NNET, **kw), param_dtype=torch.float32, device="cpu")
    if params is None:
        return m.init_weights(torch.Generator().manual_seed(0),
                              zero_init_std=ZERO_INIT_STD)
    return load_unet_from_jax(m, params)


@pytest.fixture(scope="module")
def jax_params():
    """The toy's params, drawn by the port (its output convs live), as a
    Flax tree of numpy arrays."""
    return {"params": jax.tree.map(
        np.asarray, unet_torch_to_flax(_port_unet().state_dict()))}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_scaled(port, ref, tol=TOL):
    """Within ``tol`` of the reference tensor's largest magnitude."""
    r = _np(ref)
    np.testing.assert_allclose(_np(port), r, rtol=0,
                               atol=tol * float(np.abs(r).max()) + 1e-12)


def _jit_step(monkeypatch, step_j):
    """``step_j`` jitted with the draws as arguments: jax.random.uniform and
    normal return them in call order, so one trace serves every step."""
    queue = []

    def fake(key, shape=(), dtype=jnp.float32, *args, **kw):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return arr.astype(dtype)

    monkeypatch.setattr(jax.random, "uniform", fake)
    monkeypatch.setattr(jax.random, "normal", fake)

    def run(state, batch, draws):
        queue[:] = draws
        return step_j(state, batch, jax.random.PRNGKey(0))

    return jax.jit(run)


def _draws(gen, x_shape, steps):
    """The port's draws in its order (moments noise, t, eps), from a copy
    of ``gen``."""
    g = torch.Generator().set_state(gen.get_state())
    out = []
    for _ in range(steps):
        out.append(torch.randn(x_shape, generator=g).numpy())
        out.append(torch.rand((x_shape[0],), generator=g).numpy())
        out.append(torch.randn(x_shape, generator=g).numpy())
    return out


def _moments(seed=0):
    r = np.random.default_rng(seed)
    mom = r.standard_normal((B, 16, 16, 8)).astype(np.float32)
    mom[..., 4:] = -2.0 + 0.5 * mom[..., 4:]  # logvar
    return mom


@pytest.mark.parametrize("attn_impl,context", [
    pytest.param("pallas", False, id="pallas"),
    pytest.param("auto", False, id="auto"),
    pytest.param("auto", True, id="auto-context")])
def test_unet_train_steps_match_jax(jax_params, monkeypatch, attn_impl,
                                    context):
    """Two train steps (moments resampling, CFM loss, grads, global norm,
    fused Adam with L2 + EMA, a 2-step warmup) against the JAX step. With
    ``context``, the batch carries text embeddings [B, 3, context_dim]
    that both steps pass to the model's cross-attention, and the port's
    loss differs from that of the same step without them. The context case
    takes one step: Adam's second update divides each gradient element by
    its own history, so the f32 round-off of an element some 650 times
    below its tensor's largest (a zero-initialised bias behind the
    cross-attention) reaches the parameter at full size (2.3e-4 of scale
    after two steps); the first update is ``lr * g / (|g| + eps)``, and the
    two-step Adam path is held by the cases without context."""
    lr_j = jstate.get_lr_schedule("customized", 1e-3, warmup_steps=2)
    tx_j = jstate.get_optimizer("adam", lr_j, betas=(0.9, 0.99),
                                weight_decay=0.03)
    state_j = jstate.TrainState.create(
        jax.tree.map(jnp.asarray, jax_params), tx_j)
    step_j = jstep.make_train_step(JaxUNet(**NNET, attn_impl=attn_impl),
                                   tx_j, lr_schedule=lr_j, ema_rate=0.9,
                                   latents_from_moments=True)
    lr = tstate.get_lr_schedule("customized", 1e-3, warmup_steps=2)
    tx = tstate.get_optimizer("adam", lr, betas=(0.9, 0.99),
                              weight_decay=0.03)
    model = _port_unet(jax_params, attn_impl=attn_impl)
    state = tstate.TrainState.create(dict(model.named_parameters()), tx)
    step = tstep.make_train_step(model, tx, lr_schedule=lr, ema_rate=0.9,
                                 latents_from_moments=True)
    gen = torch.Generator().manual_seed(5)
    steps = 1 if context else 2
    draws = [jnp.asarray(d) for d in _draws(gen, (B, 16, 16, 4), steps)]
    run_j = _jit_step(monkeypatch, step_j)
    mom = _moments(6)
    batch = {"x": mom}
    if context:
        batch["context"] = np.random.default_rng(7).standard_normal(
            (B, 3, NNET["context_dim"])).astype(np.float32)
        # the same first step without the context, on a second model
        bare = _port_unet(jax_params, attn_impl=attn_impl)
        m_bare = tstep.make_train_step(
            bare, tx, lr_schedule=lr, ema_rate=0.9,
            latents_from_moments=True)(
                tstate.TrainState.create(dict(bare.named_parameters()), tx),
                {"x": torch.from_numpy(mom)},
                torch.Generator().set_state(gen.get_state()))
    for i in range(steps):
        state_j, m_j = run_j(state_j,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             draws[3 * i:3 * i + 3])
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                 gen)
        for k in ("loss", "grad_norm", "lr", "nonfinite_skip"):
            _close_scaled(m[k], m_j[k])
        assert float(m["grad_norm"]) > 0
        if context and i == 0:
            assert abs(float(m["loss"]) - float(m_bare["loss"])) > 1e-4
    adam_j = [s for s in state_j.opt_state
              if hasattr(s, "mu") and hasattr(s, "nu")][0]
    assert int(state.step) == int(adam_j.count) == steps
    for mine, ref, tol in ((state.params, state_j.params, ADAM_TOL),
                           (state.ema_params, state_j.ema_params, ADAM_TOL),
                           (state.opt_state.mu, adam_j.mu, TOL),
                           (state.opt_state.nu, adam_j.nu, TOL)):
        ref = unet_flax_to_torch(ref)
        assert mine.keys() == ref.keys()
        for k in mine:
            _close_scaled(mine[k], ref[k], tol)


def test_remat_leaves_values_and_grads_unchanged(jax_params):
    """use_checkpoint (each ResBlock and SpatialTransformer recomputed in
    the backward) gives exactly the values and gradients of the model
    without it, with kernel 7's and kernel 8's twins on the route."""
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.standard_normal((B, 16, 16, 4)).astype(np.float32))
    t = torch.from_numpy(r.random(B).astype(np.float32))
    out = {}
    for remat in (False, True):
        model = _port_unet(jax_params, attn_impl="pallas",
                           use_checkpoint=remat)
        v, _ = model(x, t)
        grads = torch.autograd.grad(v.square().mean(),
                                    list(model.parameters()))
        out[remat] = [v] + list(grads)
    assert float(out[False][0].detach().abs().max()) > 1e-3
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def _pooled_std(ws):
    """The std of every weight divided by its fan_in^-1/2, pooled."""
    return float(torch.cat([(w.detach() / w[0].numel() ** -0.5).flatten()
                            for w in ws]).std())


def test_init_matches_flax_lecun_and_embed():
    """lecun_normal_ draws the std of Flax's lecun_normal (truncated at 2
    and rescaled by 0.8796, so the drawn std is fan_in^-1/2) for a conv and
    a dense; the UNet's label embedding the std of nn.Embed's default
    (features^-1/2). Each within 2% of Flax's draw of the same shape. The
    UNet, U-ViT and VAE draw their convs so; the UNet's output convs are
    still zero by default."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for shape_t, shape_j in (((256, 64, 3, 3), (3, 3, 64, 256)),
                             ((512, 256), (256, 512))):
        w = torch.empty(shape_t)
        lecun_normal_(w, g)
        ref = np.asarray(jax.nn.initializers.lecun_normal()(key, shape_j))
        assert abs(float(w.std()) / float(ref.std()) - 1) < 0.02
        assert float(w.abs().max()) <= 2 * w[0].numel() ** -0.5 / \
            TRUNC_NORMAL_STD
    m = UNet(**dict(NNET, num_classes=100), device="cpu").init_weights(g)
    emb = fnn.Embed(100, m.label_emb.weight.shape[1]).init(
        key, jnp.zeros((1,), jnp.int32))["params"]["embedding"]
    assert abs(float(m.label_emb.weight.detach().std()) / float(np.std(emb))
               - 1) < 0.02
    zero = {id(c) for c in m._zero_init_convs()}
    assert all(not c.weight.any() for c in m._zero_init_convs())
    convs = [mod.weight for mod in m.modules()
             if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear,
                                 torch.nn.Conv1d)) and id(mod) not in zero]
    assert abs(_pooled_std(convs) - 1) < 0.02
    u = UViT(img_size=8, embed_dim=64, depth=2, num_heads=2,
             device="cpu").init_weights(g)
    assert abs(_pooled_std([u.patch_embed.proj.weight,
                            u.final_layer.weight]) - 1) < 0.05
    vae = AutoencoderKL(dict(ch=32, out_ch=3, ch_mult=(1, 2),
                             num_res_blocks=1, attn_resolutions=(),
                             in_channels=3, resolution=32, z_channels=4,
                             double_z=True), device="cpu").init_weights(g)
    assert abs(_pooled_std([mod.weight for mod in vae.modules()
                            if isinstance(mod, torch.nn.Conv2d)]) - 1) < 0.02


def test_grad_clip_matches_optax_chain():
    """FusedAdam with grad_clip (clip by the global norm, then L2, Adam,
    LR, EMA) against the JAX package's get_optimizer(grad_clip=...) optax
    chain: two steps whose gradients' norm is above the clip, one below."""
    r = np.random.default_rng(11)
    shapes = {"a": (8, 5), "b": (5,), "c": (3, 3, 4)}
    params = {k: r.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    clip = 1.0
    lr_j = jstate.get_lr_schedule("customized", 1e-2, warmup_steps=1)
    tx_j = jstate.get_optimizer("adam", lr_j, betas=(0.9, 0.99),
                                weight_decay=0.03, grad_clip=clip)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    ema_j = dict(p_j)
    opt_j = tx_j.init(p_j)
    lr = tstate.get_lr_schedule("customized", 1e-2, warmup_steps=1)
    tx = tstate.get_optimizer("adam", lr, betas=(0.9, 0.99),
                              weight_decay=0.03, grad_clip=clip)
    state = tstate.TrainState.create(
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}, tx)
    norms = []
    for scale in (5.0, 2.0, 0.1):
        grads = {k: r.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        total = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        grads = {k: g * scale / total for k, g in grads.items()}
        upd, opt_j = tx_j.update({k: jnp.asarray(g) for k, g in grads.items()},
                                 opt_j, p_j)
        p_j = {k: p_j[k] + upd[k] for k in p_j}
        ema_j = jstate.ema_update(p_j, ema_j, 0.9)
        tg = {k: torch.from_numpy(g) for k, g in grads.items()}
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(tg.values()))))
        norms.append(float(norm))
        tstep.fused_adam_ema(tx, state, tg, 0.9, grad_norm=norm)
        for k in params:
            _close_scaled(state.params[k], p_j[k], 1e-5)
            _close_scaled(state.ema_params[k], ema_j[k], 1e-5)
    assert norms[0] > clip and norms[1] > clip and norms[2] < clip
    adam_j = [s for s in opt_j if hasattr(s, "mu") and hasattr(s, "nu")][0]
    for k in params:
        _close_scaled(state.opt_state.mu[k], adam_j.mu[k], 1e-5)
        _close_scaled(state.opt_state.nu[k], adam_j.nu[k], 1e-5)


def test_train_cli_trains_the_unet(tmp_path):
    """train_lfm on synthetic_unet: the SD-UNet trains on its own "auto"
    with the reference init (zero output convs), and its checkpoint's
    params load strictly into a fresh model; a config's grad_clip reaches
    the optimizer."""
    cfg = get_config("synthetic_unet")
    assert train_lfm.train_attn_impl(cfg) == "auto"
    assert train_lfm.train_attn_impl(get_config("synthetic_smoke")) == \
        "pallas_packed"
    assert train_lfm.train_attn_impl(dict(cfg, nnet=dict(
        cfg["nnet"], attn_impl="xla"))) == "xla"
    out = train_lfm.run("synthetic_unet", n_steps=2, device="cpu",
                        workdir=str(tmp_path), log=lambda s: None)
    model = out["model"]
    assert isinstance(model, UNet)
    assert {m.attn_impl for m in model.modules()
            if hasattr(m, "attn_impl")} == {"auto"}
    assert all(np.isfinite(h["loss"]) and h["nonfinite_skip"] == 0
               for h in out["history"])
    sd = checkpoint.load(out["checkpoint"])
    assert int(sd["step"]) == 2
    fresh = train_lfm.build_train_model(cfg, torch.device("cpu"), seed=1)
    assert not fresh.out[2].weight.any()
    fresh.load_state_dict(sd["params"], strict=True)
    cfg["train"]["grad_clip"] = 1.0
    tx, _ = train_lfm.build_optimizer(cfg)
    assert tx.grad_clip == 1.0
    assert train_lfm.build_optimizer(get_config("synthetic_unet"))[0] \
        .grad_clip is None
