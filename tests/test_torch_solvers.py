"""uspace_tpu_torch's adaptive solvers held to the JAX package's two
adaptive loops: ``odeint_adaptive`` (the device ``while_loop``) and
``odeint_adaptive_host(program="stages")``, whose host-driven design the
port copies.

Fields, with inputs from numpy seeds:
- a linear ODE ``dx/dt = A x`` (f32) with the closed form ``expm(A t)``;
- a toy U-ViT (depth 2, embed 32) loaded from one JAX param tree, in f32
  and in bf16 (the model's compute dtype);
- the f32 toy U-ViT with its output rounded to bf16: one bf16 field that
  both packages evaluate to the same values, so that the solvers' own bf16
  rounding (each stage combination rounded to the field's dtype) is all
  that can differ.

What is held, and why:
- identical ``steps``, ``accepted`` and ``nfe``: the controller makes the
  same decisions;
- solutions within 1e-5 of max(1, |x|) in f32: the same arithmetic, with
  f32 sums in another order (measured <= 4e-7 of it); 3e-5 on the linear
  field, whose solves take up to 215 steps (measured 1.1e-5, adaptive_heun
  in reverse);
- bf16 U-ViT: within one bf16 step of the largest |x| (the two packages'
  bf16 fields differ by bf16 roundings, since JAX on the CPU keeps bf16
  chains in f32), at rtol = atol = 1e-4: at 1e-5 the error estimate of a
  bf16 field is at the level of those roundings, and bosh3 then takes one
  step more or less on the port's field;
- the shared bf16 field: within 2.5e-4 (measured <= 1.6e-4), a limit that
  a solver which skips the bf16 rounding of the stage combinations exceeds
  (measured >= 4.1e-4; ``test_bf16_stage_rounding_is_held``).

The linear field is 8x faster than the unit rotation: with A itself the
first dopri5 step's error ratio (~6e-6) is f32 rounding noise at the edge
of the controller's growth clip, where sums in another order decide it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from uspace_tpu.core import flow as jflow
from uspace_tpu.core import solvers as jsolvers
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu_torch.codecs.convert import load_uvit_from_jax
from uspace_tpu_torch.core import flow as tflow
from uspace_tpu_torch.core import solvers as tsolvers
from uspace_tpu_torch.models import UViT

A = 8.0 * np.array([[-0.5, 1.0], [-1.0, -0.5]], np.float32)
STATS = ("steps", "accepted", "nfe")


def _jstats(s):
    return {k: int(s[k]) for k in STATS}


def _both_jax(jf, x0, t0, t1, **kw):
    """(x, stats) of each JAX adaptive loop."""
    xd, sd = jsolvers.odeint_adaptive(jf, jnp.asarray(x0), t0, t1,
                                      return_stats=True, **kw)
    xh, sh = jsolvers.odeint_adaptive_host(jf, jnp.asarray(x0), t0, t1,
                                           return_stats=True,
                                           program="stages", **kw)
    return [(np.asarray(xd, np.float32), _jstats(sd)),
            (np.asarray(xh, np.float32), _jstats(sh))]


def _check(port, refs, atol, rel=1e-5):
    """Identical step counts; ``atol`` None: ``rel`` of max(1, |x|)."""
    x, st = port
    x = x.float().numpy()
    for xr, sr in refs:
        assert {k: st[k] for k in STATS} == sr
        tol = rel * max(1.0, float(np.abs(xr).max())) if atol is None \
            else atol
        np.testing.assert_allclose(x, xr, rtol=0, atol=tol)


def _linear(dtype=torch.float32):
    a = torch.from_numpy(A)
    return (lambda t, x: jnp.asarray(x) @ jnp.asarray(A).T,
            lambda t, x: (x @ a.T).to(dtype))


@pytest.mark.parametrize("method", tsolvers.ADAPTIVE_METHODS)
@pytest.mark.parametrize("controller", tsolvers.CONTROLLERS)
@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (1.0, 0.0)])
def test_linear_field_matches_jax_and_closed_form(method, controller, t0, t1):
    x0 = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)
    jf, tf = _linear()
    kw = dict(method=method, controller=controller)
    refs = _both_jax(jf, x0, t0, t1, **kw)
    x, st = tsolvers.odeint_adaptive(tf, torch.from_numpy(x0), t0, t1,
                                     return_stats=True, **kw)
    _check((x, st), refs, None, rel=3e-5)
    assert st["t"] == t1
    # the closed form, to the accuracy rtol = atol = 1e-5 buys: a global
    # error of 1e-3 of the larger of |x0| and |x1| (measured <= 2.4e-4,
    # bosh3 in reverse, where the state grows ~50x)
    exact = x0.astype(np.float64) @ expm(A.astype(np.float64) * (t1 - t0)).T
    top = max(np.abs(x0).max(), np.abs(exact).max())
    np.testing.assert_allclose(x.numpy(), exact, rtol=0, atol=1e-3 * top)


def test_initial_step_matches_jax():
    """The Hairer heuristic term by term, in both directions (to 1e-6: f32
    sums in another order move the last bits)."""
    x0 = np.random.default_rng(1).standard_normal((4, 2)).astype(np.float32)
    jf, tf = _linear()
    for t0, d in ((0.0, 1.0), (1.0, -1.0)):
        for order in (2, 3, 5):
            ref = jsolvers._initial_step(
                jf, jnp.float32(t0), jnp.asarray(x0), jf(t0, x0),
                jnp.float32(d), order, 1e-5, 1e-5)
            x = torch.from_numpy(x0)
            h = tsolvers._initial_step(tf, t0, x, tf(t0, x), d, order, 1e-5,
                                       1e-5)
            assert h == pytest.approx(float(ref), rel=1e-6, abs=0)


TOY = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=2,
           num_heads=4)


@pytest.fixture(scope="module")
def toy():
    z = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    params = jax.jit(JaxUViT(**TOY).init)(
        jax.random.PRNGKey(1), jnp.asarray(z), jnp.zeros((2,)))
    params = jax.tree.map(np.asarray, params)
    fields = {}
    for name, jd, td in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JaxUViT(dtype=jd, **TOY)
        tm = load_uvit_from_jax(UViT(dtype=td, device="cpu", **TOY),
                                params).eval()
        fields[name] = (
            lambda t, x, jm=jm: jm.apply(
                params, x, jnp.full((2,), t, jnp.float32))[0],
            lambda t, x, tm=tm: tm(x, torch.full((2,), float(t)))[0])
    jf, tf = fields["f32"]
    fields["shared_bf16"] = (lambda t, x: jf(t, x).astype(jnp.bfloat16),
                             lambda t, x: tf(t, x).to(torch.bfloat16))
    return z, params, fields


# each method on each field, and over the two fields each method with
# both controllers and in both directions
UVIT_CASES = [("f32", "dopri5", "i", False), ("f32", "bosh3", "pi", True),
              ("f32", "adaptive_heun", "pi", False),
              ("bf16", "dopri5", "pi", True), ("bf16", "bosh3", "i", False),
              ("bf16", "adaptive_heun", "i", True)]


@pytest.mark.parametrize("field,method,controller,reverse", UVIT_CASES)
def test_uvit_field_matches_jax(toy, field, method, controller, reverse):
    z, _, fields = toy
    jf, tf = fields[field]
    t0, t1 = (1.0, 0.0) if reverse else (0.0, 1.0)
    tol = 1e-5 if field == "f32" else 1e-4
    kw = dict(method=method, controller=controller, rtol=tol, atol=tol)
    refs = _both_jax(jf, z, t0, t1, **kw)
    with torch.no_grad():
        x, st = tsolvers.odeint_adaptive(tf, torch.from_numpy(z), t0, t1,
                                         return_stats=True, **kw)
    assert x.dtype == torch.float32 and st["t"] == t1
    top = float(np.abs(refs[0][0]).max())
    atol = None if field == "f32" else 2.0 ** (np.floor(np.log2(top)) - 7)
    _check((x, st), refs, atol)


@pytest.mark.parametrize("controller,reverse", [("i", False), ("pi", True)])
def test_bf16_stage_rounding_is_held(toy, controller, reverse, monkeypatch):
    """One bf16 field for both packages at rtol = atol = 1e-5: the port
    rounds each stage combination to bf16 as the JAX loops do, and a port
    that kept it in f32 (the control) falls outside the same limit."""
    z, _, fields = toy
    jf, tf = fields["shared_bf16"]
    t0, t1 = (1.0, 0.0) if reverse else (0.0, 1.0)
    kw = dict(method="dopri5", controller=controller)
    refs = _both_jax(jf, z, t0, t1, **kw)

    def solve():
        with torch.no_grad():
            return tsolvers.odeint_adaptive(tf, torch.from_numpy(z), t0, t1,
                                            return_stats=True, **kw)

    _check(solve(), refs, 2.5e-4)
    combine = tsolvers._combine
    monkeypatch.setattr(tsolvers, "_combine", lambda w, ks: combine(
        w, [k.float() for k in ks]))
    x_ctl, _ = solve()
    assert np.abs(x_ctl.numpy() - refs[1][0]).max() > 2.5e-4


def test_decode_fixadp_matches_jax(toy):
    """``flow.decode`` with the fixed/adaptive split at ``t_edit``: Euler
    steps of 0.1 to t = 0.3, then dopri5 with the PI controller."""
    z, params, fields = toy
    jm = JaxUViT(**TOY)
    sk = {"solver": "fixadp", "solver_fix": "euler", "solver_fix_step": 0.1,
          "solver_adaptive": "dopri5", "controller": "pi"}
    ref = jflow.decode(lambda t, x: jm.apply(params, x, t)[0],
                       jnp.asarray(z), sk, t_edit=0.3)
    tm = load_uvit_from_jax(UViT(device="cpu", **TOY), params).eval()
    calls = []

    def vf(t, x):
        calls.append(float(t[0]))
        return tm(x, t)[0]

    stats = {}
    with torch.no_grad():
        out = tflow.decode(vf, torch.from_numpy(z), sk, t_edit=0.3,
                           stats=stats)
    jf = fields["f32"][0]
    x_mid = jsolvers.odeint_fixed(jf, jnp.asarray(z), 0.0, 0.3, 3)
    _, sh = jsolvers.odeint_adaptive_host(jf, x_mid, 0.3, 1.0,
                                          controller="pi", return_stats=True,
                                          program="stages")
    _check((out, stats), [(np.asarray(ref), sh)], None)
    assert np.allclose(calls[:3], [0.0, 0.1, 0.2])  # the Euler part
    assert len(calls) == 3 + stats["nfe"] and stats["t"] == 1.0


def test_max_steps_stop_is_reported():
    """The loops stop at max_steps attempts, short of t1, without a
    word: the port's stats carry the time reached. The first step's error
    ratio here is f32 rounding noise (~1e-9), so the second step's size
    differs in its last bits from JAX's and the states by up to 6e-5 of
    their scale after three steps: held to 1e-4 of it."""
    x0 = np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)
    jf, tf = _linear()
    refs = _both_jax(jf, x0, 0.0, 1.0, method="bosh3", max_steps=3)
    stats = {}
    x = tsolvers.odeint(tf, torch.from_numpy(x0), 0.0, 1.0,
                        {"solver": "adaptive", "solver_adaptive": "bosh3",
                         "controller": "i"}, stats=stats)
    full = dict(stats)
    x, st = tsolvers.odeint_adaptive(tf, torch.from_numpy(x0), 0.0, 1.0,
                                     method="bosh3", max_steps=3,
                                     return_stats=True)
    _check((x, st), refs, 1e-4 * max(1.0, float(np.abs(x0).max())))
    assert st["steps"] == 3 and 0.0 < st["t"] < 1.0
    assert full["steps"] > 3 and full["t"] == 1.0
    assert tsolvers.odeint_adaptive_host is tsolvers.odeint_adaptive


def test_dispatch_refuses():
    jf, tf = _linear()
    x0 = torch.ones(1, 2)
    with pytest.raises(ValueError, match="fixed-step"):
        tsolvers.odeint(lambda t, x: (tf(t, x), None), x0, 0.0, 1.0,
                        {"solver": "adaptive"}, has_aux=True)
    with pytest.raises(ValueError, match="t_mid"):
        tsolvers.odeint(tf, x0, 0.0, 1.0, {"solver": "fixadp"})
    # a stage-delta pair runs, with the base once per step (plus the two
    # evaluations of the initial-step heuristic); a bare field is refused
    calls = {"base": 0, "delta": 0}

    def base(t, x):
        calls["base"] += 1
        return tf(t, x), None

    def delta(t, x, cache):
        calls["delta"] += 1
        return tf(t, x)

    st = {}
    x = tsolvers.odeint(None, x0, 0.0, 1.0, {"solver": "adaptive",
                                            "stage_delta": (base, delta)},
                        stats=st)
    assert st["t"] == 1.0 and bool(torch.isfinite(x).all())
    assert calls == {"base": st["steps"] + 2, "delta": 5 * st["steps"]}
    with pytest.raises(ValueError, match="sampling layer"):
        tsolvers.odeint(tf, x0, 0.0, 1.0, {"solver": "adaptive",
                                           "field": "stage_delta_int8"})
    with pytest.raises(ValueError, match="controller"):
        tsolvers.odeint_adaptive(tf, x0, 0.0, 1.0, controller="pid")
    with pytest.raises(NotImplementedError, match="rk45"):
        tsolvers.odeint_adaptive(tf, x0, 0.0, 1.0, method="rk45")
    with pytest.raises(ValueError, match="unknown solver"):
        tsolvers.odeint(tf, x0, 0.0, 1.0, {"solver": "implicit"})
