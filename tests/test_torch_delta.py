"""The base-anchored stage-delta int8 field of uspace_tpu_torch
(``ops/delta.py``, ``core/delta_field.py``, the solver's ``stage_delta``
option, ``sample_lfm --field``), held to the JAX package's.

At the JAX tests' toy size (a U-ViT of embed 64, depth 2, 2 heads, patch
4 on 8 x 8 latents: L = 5 tokens, padded to 32 rows; hidden 256 in 4
strips), bf16 and f32, inputs from numpy seeds; JAX runs its Pallas kernels
in interpret mode, as its own tests do.

What is held, and why:
- each of the four kernels' plain twins against its JAX kernel, on the L
  real rows: int8 codes equal but for one-step flips where an f32 sum runs
  in another order (at most 0.5% of them), row scales within 1e-6, outputs
  at the int8 tolerances (max-abs 2e-3 / 2e-2 and rel-L2 1e-4 / 5e-3 in f32
  / bf16), the delta kernels on what they add to their cache (``xm - xm_b``,
  ``o - x - m_b``), which the cache would otherwise hide;
- ``prepare_delta_params``: codes and scales bit-equal to JAX's;
- the whole base field against JAX's, fused and unfused: in bf16 within
  5e-2 (flips compound over the blocks: the rule for int8 fields), in
  f32 at the per-call tolerance (nothing flips); the port's delta on JAX's
  own cache against JAX's delta on it at the per-call tolerances (bf16
  fused, f32 fused and unfused): this holds the delta path tightly where
  the whole bf16 field cannot be;
- the invariants of ``tests/test_delta_field.py``: a delta evaluation at
  the base's own point equal to the base bit for bit (fused), within 5e-3
  unfused; deltas tracking full evaluations within 0.04; fused against
  unfused within 0.03;
- a toy dopri5 solve at rtol = atol = 1e-4: NFE at most 1.3 x the bf16
  field's and the solution within 0.05 of it; against JAX's host
  stage-delta solve the same NFE or one step attempt more or less (their
  first steps sit at the same error ratio up to f32 sums), the solution
  within the int8 field rule;
- every refusal, and no launch counted by a twin.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.core import delta_field as jdf
from uspace_tpu.core import solvers as jsolvers
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.ops import delta as jdelta
from uspace_tpu.ops.quant import quantize_colwise as jquantize_colwise
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import load_uvit_from_jax
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.core import delta_field as tdf
from uspace_tpu_torch.core import flow as tflow
from uspace_tpu_torch.core import solvers as tsolvers
from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops import mlp as tmlp
from uspace_tpu_torch.ops.quant import quantize_colwise

TOY = dict(img_size=8, patch_size=4, in_chans=4, embed_dim=64, depth=2,
           num_heads=2)
H, C, L, EPS = 2, 64, 5, 1e-5
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
INT8_TOL = {"f32": (2e-3, 1e-4), "bf16": (2e-2, 5e-3)}
FLIP_RATE = 5e-3
FIELD_REL = 5e-2
SOLVE = dict(method="dopri5", rtol=1e-4, atol=1e-4, controller="i",
             safety=0.9)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(port, ref, dt, base=None):
    """The int8 tolerances: max-abs, and rel-L2 of ``x - base``."""
    atol, rtol = INT8_TOL[dt]
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    err = np.abs(p - r).max()
    assert err <= atol, (err, atol)
    if base is not None:
        p, r = p - _np(base), r - _np(base)
    got = np.linalg.norm(p - r) / np.linalg.norm(r)
    assert got <= rtol, (got, rtol)


def _codes(port, ref):
    """int8 codes equal but for one-step flips at a small rate."""
    d = np.abs(_np(port) - _np(ref))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= FLIP_RATE, (d > 0).mean()


def _scales(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=1e-6)


def _to_torch(a):
    """A JAX array as the torch tensor of the same dtype (bf16 exactly)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cache_to_torch(cache):
    return {k: (_cache_to_torch(v) if isinstance(v, dict) else _to_torch(v))
            for k, v in cache.items()}


def _rand(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# the four kernels' twins against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


def _weights(r, k, n, std):
    w = (r.standard_normal((k, n)) * std).astype(np.float32)
    jq, js = jquantize_colwise(jnp.asarray(w))
    tq, ts = quantize_colwise(torch.from_numpy(w))
    assert (np.asarray(jq) == tq.numpy()).all()
    return (jq, js), (tq, ts)


def _ln(r):
    return ((1 + 0.1 * r.standard_normal(C)).astype(np.float32),
            (0.1 * r.standard_normal(C)).astype(np.float32))


def _both(a, dt):
    """numpy f32 -> (JAX array, torch tensor) in the dtype ``dt``."""
    jd, td = DT[dt]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _attn_case(seed, dt):
    r = _rand(seed)
    xb = r.standard_normal((2, L, C)).astype(np.float32)
    x = xb + 1e-2 * r.standard_normal(xb.shape).astype(np.float32)
    s, b = _ln(r)
    (jq, js), (tq, ts) = _weights(r, C, 3 * C, 0.2)
    (jp, jsp), (tp, tsp) = _weights(r, C, C, 0.1)
    jxb, txb = _both(xb, dt)
    jx, tx = _both(x, dt)
    ja, jqq, jqs = jdelta.base_attn_block(jxb, jnp.asarray(s), jnp.asarray(b),
                                          jq, js, H, EPS, interpret=True)
    ta, tqq, tqs = tdelta.base_attn_block(txb, torch.from_numpy(s),
                                          torch.from_numpy(b), tq, ts, H, EPS)
    return SimpleNamespace(**locals())


def _mlp_case(seed, dt, hidden=4 * C):
    r = _rand(seed)
    xb = r.standard_normal((2, L, C)).astype(np.float32)
    x = xb + 1e-2 * r.standard_normal(xb.shape).astype(np.float32)
    s, b = _ln(r)
    (j1, js1), (t1, ts1) = _weights(r, C, hidden, 0.1)
    (j2, js2), (t2, ts2) = _weights(r, hidden, C, 0.05)
    b1 = (r.standard_normal(hidden) * 0.02).astype(np.float32)
    b2 = (r.standard_normal(C) * 0.02).astype(np.float32)
    jxb, txb = _both(xb, dt)
    jx, tx = _both(x, dt)
    jout = jdelta.base_mlp_block(
        jxb, jnp.asarray(s), jnp.asarray(b), j1, js1, jnp.asarray(b1), j2,
        js2, jnp.asarray(b2), EPS, interpret=True, mode="grad")
    tout = tdelta.base_mlp_block(
        txb, torch.from_numpy(s), torch.from_numpy(b), t1, ts1,
        torch.from_numpy(b1), t2, ts2, torch.from_numpy(b2), EPS,
        mode="grad")
    return SimpleNamespace(**locals())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_base_attn_twin_matches_jax(dt):
    k = _attn_case(0, dt)
    assert tuple(k.tqq.shape) == k.jqq.shape == (2, 32, 3 * C)
    assert tuple(k.tqs.shape) == k.jqs.shape == (2, 32, 1)
    _close(k.ta, k.ja, dt)
    _codes(k.tqq[:, :L], k.jqq[:, :L])
    _scales(k.tqs[:, :L], k.jqs[:, :L])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_delta_attn_twin_matches_jax(dt):
    k = _attn_case(1, dt)
    r = _rand(11)
    jxmb, txmb = _both(r.standard_normal((2, L, C)).astype(np.float32), dt)
    # both on the JAX base's cache, so that only the delta kernel differs
    jxm = jdelta.delta_attn_block(
        k.jx, k.jxb, k.jqq, k.jqs, k.ja, jxmb, jnp.asarray(k.s),
        jnp.asarray(k.b), k.jq, k.js, k.jp, k.jsp, H, EPS, interpret=True)
    txm = tdelta.delta_attn_block(
        k.tx, k.txb, _to_torch(k.jqq), _to_torch(k.jqs), _to_torch(k.ja),
        txmb, torch.from_numpy(k.s), torch.from_numpy(k.b), k.tq, k.ts,
        k.tp, k.tsp, H, EPS)
    _close(txm, jxm, dt, base=txmb)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_base_mlp_twin_matches_jax(dt):
    k = _mlp_case(2, dt)
    assert [tuple(t.shape) for t in k.tout] == [a.shape for a in k.jout]
    assert tuple(k.tout[2].shape) == (2 * L, 4)  # one scale per strip
    _close(k.tout[0], k.jout[0], dt, base=k.txb)
    _codes(k.tout[1], k.jout[1])
    _scales(k.tout[2], k.jout[2])
    _close(k.tout[3], k.jout[3], dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_delta_mlp_twin_matches_jax(dt):
    k = _mlp_case(3, dt)
    _, jgq, jgs, jm = k.jout
    jo = jdelta.delta_mlp_block(
        k.jx, k.jxb, jgq, jgs, jm, jnp.asarray(k.s), jnp.asarray(k.b), k.j1,
        k.js1, k.j2, k.js2, EPS, interpret=True, grad=True)
    tm = _to_torch(jm)
    to = tdelta.delta_mlp_block(
        k.tx, k.txb, _to_torch(jgq), _to_torch(jgs), tm, torch.from_numpy(k.s),
        torch.from_numpy(k.b), k.t1, k.ts1, k.t2, k.ts2, EPS, grad=True)
    _close(to, jo, dt, base=k.tx.float() + tm.float())


def test_twins_count_no_launches():
    tdelta.reset_launches()
    _attn_case(4, "bf16")
    _mlp_case(5, "bf16")
    assert set(tdelta.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# the field against the JAX field
# ---------------------------------------------------------------------------


def _build_toy(dt):
    """The JAX toy field (f32 params) with its jitted fused and unfused
    base and delta, and the port's field on the same weights."""
    jd, td = DT[dt]
    jm = JaxUViT(dtype=jd, **TOY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                     jnp.zeros((1,)))
    dp = jdf.prepare_delta_params(params)
    jit = {}
    for fused in (True, False):
        jit[fused] = (
            jax.jit(lambda dp, t, x, f=fused: jdf.anchored_vf_base(
                jm, dp, t, x, fused=f, hidden_mode="grad")),
            jax.jit(lambda dp, t, x, c, f=fused: jdf.anchored_vf_delta(
                jm, dp, t, x, c, fused=f)))
    tm = load_uvit_from_jax(UViT(dtype=td, param_dtype=torch.float32,
                                 device="cpu", **TOY),
                            jax.tree.map(np.asarray, params))
    return SimpleNamespace(jm=jm, params=params, dp=dp, jit=jit, tm=tm,
                           tdp=tdf.prepare_delta_params(tm))


@pytest.fixture(scope="module")
def toys():
    """``toys(dt)``: the toy of dtype ``dt``, built once per module."""
    built = {}

    def get(dt):
        if dt not in built:
            built[dt] = _build_toy(dt)
        return built[dt]
    return get


@pytest.fixture(scope="module")
def toy(toys):
    return toys("bf16")


def _z(seed, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 8, 8, 4)).astype(np.float32)


def _port(toy, t, z, cache=None, fused=True, hidden_mode="grad"):
    with torch.no_grad():
        if cache is None:
            return tdf.anchored_vf_base(toy.tm, toy.tdp, torch.tensor(t),
                                        torch.from_numpy(z), fused=fused,
                                        hidden_mode=hidden_mode)
        return tdf.anchored_vf_delta(toy.tm, toy.tdp, torch.tensor(t),
                                     torch.from_numpy(z), cache, fused=fused)


def test_prepare_delta_params_bit_equal(toy):
    names = tdf._block_names(toy.tm.depth)
    assert set(toy.tdp) == set(toy.dp) == set(names) | {"_plain"}
    for name in names:
        for k in ("qkv", "proj", "fc1", "fc2", "skip"):
            if k not in toy.dp[name]:
                assert k not in toy.tdp[name]
                continue
            np.testing.assert_array_equal(toy.tdp[name][k].kn.numpy(),
                                          np.asarray(toy.dp[name][k]["q"]))
            np.testing.assert_array_equal(
                toy.tdp[name][k].scale.numpy(),
                np.asarray(toy.dp[name][k]["s"]).reshape(-1))


@pytest.mark.parametrize("dt,fused", [("bf16", True), ("bf16", False),
                                      ("f32", True), ("f32", False)])
def test_base_field_matches_jax(toys, dt, fused):
    """bf16: the whole-field rule (a flipped code moves every later
    quantizer); f32: nothing flips, so the per-call int8 tolerance."""
    toy = toys(dt)
    z = _z(6)
    fj, cj = toy.jit[fused][0](toy.dp, jnp.float32(0.3), jnp.asarray(z))
    ft, ct = _port(toy, 0.3, z, fused=fused)
    assert ft.dtype == torch.float32 and tuple(ft.shape) == z.shape
    if dt == "bf16":
        assert _rel(ft, fj) < FIELD_REL
    else:
        _close(ft, fj, dt)
    assert set(ct) == set(cj)
    for name in tdf._block_names(toy.tm.depth):
        assert set(ct[name]) == set(cj[name])
        for k, v in ct[name].items():
            assert tuple(v.shape) == cj[name][k].shape, (name, k)
    assert ct["mid_block"]["gp_s"].shape[-1] == (4 if fused else 1)


@pytest.mark.parametrize("dt,fused", [("bf16", True), ("f32", True),
                                      ("f32", False)])
def test_delta_on_jax_cache_matches_jax(toys, dt, fused):
    """The port's delta and JAX's on JAX's own cache, at a stage's
    distance: the per-call int8 tolerance on the velocity. The unfused bf16
    delta is held by the field rule above only: JAX on the CPU keeps the
    composition's bf16 chains in f32 (ROADMAP Queue 3), which moves its
    bf16 roundings (rel-L2 about 5e-3 against the port, where f32 reads
    1e-7)."""
    toy = toys(dt)
    base, delta = toy.jit[fused]
    z = _z(7)
    _, cj = base(toy.dp, jnp.float32(0.3), jnp.asarray(z))
    z1 = z + 0.02 * _z(8)
    fj = delta(toy.dp, jnp.float32(0.32), jnp.asarray(z1), cj)
    ft = _port(toy, 0.32, z1, cache=_cache_to_torch(cj), fused=fused)
    _close(ft, fj, dt)


def test_zero_distance_delta_is_exact(toy):
    z = _z(9)
    f0, cache = _port(toy, 0.5, z)
    fd = _port(toy, 0.5, z, cache=cache)
    assert torch.equal(fd, f0)
    assert all(k in cache["mid_block"] for k in ("gp_q", "gp_s"))
    assert "e_q" not in cache["mid_block"]


def test_unfused_zero_distance_delta(toy):
    z = _z(10)
    f0, cache = _port(toy, 0.4, z, fused=False)
    assert _rel(_port(toy, 0.4, z, cache=cache, fused=False), f0) < 5e-3


@pytest.mark.parametrize("fused", [True, False])
def test_delta_tracks_full(toy, fused):
    z0 = _z(11)
    _, cache = _port(toy, 0.3, z0, fused=fused)
    z1 = z0 + 0.02 * _z(12)
    f1 = _port(toy, 0.32, z1, cache=cache, fused=fused)
    f1_full, _ = _port(toy, 0.32, z1, fused=fused)
    assert _rel(f1, f1_full) < 0.04


def test_fused_matches_unfused(toy):
    z = _z(13)
    ff, cf = _port(toy, 0.4, z)
    fu, cu = _port(toy, 0.4, z, fused=False)
    assert set(cf) == set(cu)
    assert _rel(ff, fu) < 0.03
    z1 = z + 0.03 * _z(14)
    assert _rel(_port(toy, 0.42, z1, cache=cf),
                _port(toy, 0.42, z1, cache=cu, fused=False)) < 0.03


def test_strip_count_matches_kernels():
    for hidden in (128, 4096, 96, 130, 6, 7, 1):
        assert tdf._n_strips(hidden) == tmlp.col_slices(hidden) == \
            jdf._n_strips(hidden), hidden
        assert hidden % tdf._n_strips(hidden) == 0


def test_o_is_the_block_output(toy):
    """``o`` is the stream the next block read: the skip block's input,
    recomputed from the cached outputs of the mid block and of its skip
    partner, is the cached ``xpost`` exactly."""
    _, cache = _port(toy, 0.3, _z(15))
    with torch.no_grad():
        xpost = tdf._skip_base(toy.tdp["out_blocks_0"],
                               cache["mid_block"]["o"],
                               cache["in_blocks_0"]["o"], toy.tm.dtype)
    assert torch.equal(xpost, cache["out_blocks_0"]["xpost"])


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


def _port_bf16_solve(toy, z):
    def vf(t, x):
        return toy.tm(x, torch.full((x.shape[0],), float(t)))[0].float()

    with torch.no_grad():
        return tsolvers.odeint_adaptive(vf, torch.from_numpy(z), 0.0, 1.0,
                                        return_stats=True, **SOLVE)


def test_stage_delta_solve_keeps_nfe_and_matches_jax_host(toy):
    z = _z(16)
    pair = tdf.make_delta_field(toy.tm, toy.tdp)
    with torch.no_grad():
        x_d, s_d = tsolvers.odeint_adaptive(None, torch.from_numpy(z), 0.0,
                                            1.0, return_stats=True,
                                            stage_delta=pair, **SOLVE)
    x_bf, s_bf = _port_bf16_solve(toy, z)
    assert s_d["t"] == 1.0 and bool(torch.isfinite(x_d).all())
    assert s_d["nfe"] == 2 + 6 * s_d["steps"]
    assert s_d["nfe"] <= 1.3 * s_bf["nfe"]
    assert _rel(x_d, x_bf) < 0.05

    fb = lambda t, x, p: jdf.anchored_vf_base(  # noqa: E731
        toy.jm, p, t, x, fused=True, hidden_mode="grad")
    fd = lambda t, x, c, p: jdf.anchored_vf_delta(  # noqa: E731
        toy.jm, p, t, x, c, fused=True)
    x_j, s_j = jsolvers.odeint_adaptive_host(
        None, jnp.asarray(z), 0.0, 1.0, return_stats=True, program="stages",
        vf_params=toy.dp, stage_delta=(fb, fd), **SOLVE)
    assert abs(int(s_j["nfe"]) - s_d["nfe"]) <= 6
    assert abs(int(s_j["steps"]) - s_d["steps"]) <= 1
    assert _rel(x_d, x_j) < FIELD_REL


def test_stage_delta_through_decode_counts_one_base_per_step(toy):
    """``core.flow.decode`` with ``solver_kwargs["stage_delta"]``: the base
    once per step plus the two evaluations of the initial-step heuristic,
    the delta five times per step."""
    calls = {"base": 0, "delta": 0}
    vb, vd = tdf.make_delta_field(toy.tm, toy.tdp)

    def base(t, x):
        calls["base"] += 1
        return vb(t, x)

    def delta(t, x, c):
        calls["delta"] += 1
        return vd(t, x, c)

    st = {}
    with torch.no_grad():
        x = tflow.decode(None, torch.from_numpy(_z(17)),
                         dict(solver="adaptive", stage_delta=(base, delta),
                              rtol=1e-3, atol=1e-3, controller="i"),
                         stats=st)
    assert bool(torch.isfinite(x).all()) and st["t"] == 1.0
    assert calls == {"base": st["steps"] + 2, "delta": 5 * st["steps"]}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_hidden_mode_refused_before_compute(fused):
    """A typo, or the ops' own names of the modes, raise before any compute
    (the model and the codes are None) on both paths."""
    for mode in ("gard", "e", "e+g", "Exact"):
        with pytest.raises(ValueError, match="hidden_mode"):
            tdf.anchored_vf_base(None, None, None, None, fused=fused,
                                 hidden_mode=mode)
        with pytest.raises(ValueError, match="hidden_mode"):
            tdf.make_delta_field(None, None, fused=fused, hidden_mode=mode)


def test_ops_refuse_the_next_slice_and_contradictions():
    """The ops refuse an unknown mode, the contradiction of ``grad=True``
    with a gelu cache, and scales with one value per whole row (the unfused
    base's layout) in every delta mode."""
    k = _mlp_case(18, "bf16")
    args = (k.txb, torch.from_numpy(k.s), torch.from_numpy(k.b), k.t1, k.ts1,
            torch.from_numpy(k.b1), k.t2, k.ts2, torch.from_numpy(k.b2), EPS)
    with pytest.raises(ValueError, match="expected e[|]e[+]g[|]grad"):
        tdelta.base_mlp_block(*args, mode="exact")
    _, gq, gs, m = k.tout
    dargs = (k.tx, k.txb, gq, gs, m, torch.from_numpy(k.s),
             torch.from_numpy(k.b), k.t1, k.ts1, k.t2, k.ts2, EPS)
    with pytest.raises(ValueError, match="contradict"):
        tdelta.delta_mlp_block(*dargs, gelu_cache=(gq, gs, gs), grad=True)
    row = gs[:, :1].contiguous()
    # the unfused base's per-row scales cannot reach the fused delta
    with pytest.raises(ValueError, match="gp_s must hold one scale per row"):
        tdelta.delta_mlp_block(*dargs[:3], row, *dargs[4:], grad=True)
    with pytest.raises(ValueError, match="e_s must hold one scale per row"):
        tdelta.delta_mlp_block(*dargs[:3], row, *dargs[4:])
    with pytest.raises(ValueError, match="g_s must hold one scale per row"):
        tdelta.delta_mlp_block(*dargs, gelu_cache=(gq, row, gs))
    with pytest.raises(ValueError, match="g_z must hold one scale per row"):
        tdelta.delta_mlp_block(*dargs, gelu_cache=(gq, gs, row))


def test_delta_refuses_other_caches(toy):
    """The fused delta refuses the unfused base's cache (``e_s`` with one
    scale per whole row) rather than read it as its own."""
    _, cache = _port(toy, 0.3, _z(19), fused=False, hidden_mode="exact")
    assert cache["mid_block"]["e_s"].shape[-1] == 1
    with pytest.raises(ValueError, match="e_s must hold one scale per row"):
        _port(toy, 0.3, _z(19), cache=cache)


def test_field_refuses_other_models():
    cond = UViT(device="cpu", num_classes=10, **TOY)
    with pytest.raises(NotImplementedError, match="uncond-only"):
        tdf.prepare_delta_params(cond)
    with pytest.raises(NotImplementedError, match="mlp_time_embed"):
        tdf.prepare_delta_params(UViT(device="cpu", mlp_time_embed=True,
                                      **TOY))
    with pytest.raises(NotImplementedError, match="UViT family"):
        tdf.prepare_delta_params(torch.nn.Linear(2, 2))


def test_odeint_refuses_a_bare_field():
    x0 = torch.ones(1, 2)
    with pytest.raises(ValueError, match="sampling layer"):
        tsolvers.odeint(lambda t, x: -x, x0, 0.0, 1.0,
                        {"solver": "adaptive", "field": "stage_delta_int8"})
    with pytest.raises(NotImplementedError, match="field='int4'"):
        tsolvers.odeint(lambda t, x: -x, x0, 0.0, 1.0,
                        {"solver": "adaptive", "field": "int4"})


def _smoke(**sample):
    cfg = get_config("synthetic_smoke")
    cfg["sample"].update(sample)
    return cfg


@pytest.mark.parametrize("case", ["field", "solver", "cond", "cfg", "unet"])
def test_sample_lfm_refusals(case, tmp_path):
    cfg = _smoke()
    kw = dict(field="stage_delta_int8", solver="adaptive")
    err, match = NotImplementedError, "uncond-only"
    if case == "field":
        kw["field"], match = "int4", "field='int4'"
    elif case == "solver":
        kw["solver"], err, match = "fixed", ValueError, "solver=adaptive"
    elif case == "cond":
        cfg["nnet"]["num_classes"] = 10
    elif case == "cfg":
        cfg["sample"]["cfg_scale"] = 1.5
    else:
        cfg = get_config("synthetic_unet")
        match = "UViT family"
    with pytest.raises(err, match=match):
        sample_lfm.run(config=cfg, n_samples=1, batch=1, device="cpu",
                       out=str(tmp_path), **kw)


def test_sample_lfm_stage_delta_on_cpu(tmp_path, capsys):
    """``--field stage_delta_int8`` from the flags and from the config's
    ``sample.solver_kwargs``: one adaptive batch through the twins."""
    sample_lfm.main(["--config", "synthetic_smoke", "--device", "cpu",
                     "--solver", "adaptive", "--field", "stage_delta_int8",
                     "--hidden_mode", "grad", "--rtol", "1e-3", "--atol",
                     "1e-3", "--n_samples", "2", "--batch", "2", "--out",
                     str(tmp_path / "a")])
    assert "NFE" in capsys.readouterr().out
    a = np.load(tmp_path / "a" / "0.npy")
    assert a.shape == (2, 8, 8, 4) and np.isfinite(a).all()
    cfg = get_config("synthetic_smoke")
    cfg["sample"]["solver_kwargs"].update(
        solver="adaptive", field="stage_delta_int8", rtol=1e-3, atol=1e-3)
    st = []
    sample_lfm.run(config=cfg, n_samples=2, batch=2, device="cpu",
                   out=str(tmp_path / "b"), stats=st)
    b = np.load(tmp_path / "b" / "0.npy")
    np.testing.assert_array_equal(a, b)
    assert st[0]["nfe"] == 2 + 6 * st[0]["steps"]
    assert math.isclose(st[0]["t"], 1.0)
