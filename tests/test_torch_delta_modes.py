"""The ``"exact"`` and ``"gelu"`` hidden modes of the stage-delta int8 field
of uspace_tpu_torch (``ops/delta.py`` rows 20, 21, 24 and 25,
``core/delta_field.py``, ``sample_lfm --hidden_mode``), held to the JAX
package's.

At the JAX tests' toy size (a U-ViT of embed 64, depth 2, 2 heads, patch
4 on 8 x 8 latents: L = 5 tokens; hidden 256 in 4 strips), bf16 and f32,
inputs from numpy seeds; JAX runs its Pallas kernels in interpret mode, as
its own tests do. The tolerances are ``tests/test_torch_delta.py``'s:

- each twin against its JAX kernel: int8 codes equal but for one-step
  flips where an f32 sum runs in another order (at most 0.5% of them),
  scales and zero points within 1e-6, outputs at the int8 tolerances
  (max-abs 2e-3 / 2e-2 and rel-L2 1e-4 / 5e-3 in f32 / bf16), the base on
  ``o - x``, the delta on ``o - x - m_b`` with the bf16 rel-L2 in both
  dtypes (``DELTA_TWIN_TOL``: its GELU difference turns one-ulp differences
  of XLA's CPU arithmetic into flipped dg codes);
- the whole base field against JAX's, fused and unfused: bf16 within 5e-2
  (flips compound over the blocks), f32 at the per-call tolerance; the
  port's delta on JAX's own cache against JAX's delta on it at the per-call
  tolerances;
- the invariants of ``tests/test_delta_field.py``: a delta at the base's
  own point equal to the base bit for bit in ``"exact"`` mode (fused and
  unfused) and within 5e-3 in ``"gelu"`` mode (it re-rounds the base's
  hidden residual); deltas tracking full evaluations within 0.04; fused
  against unfused within 0.03;
- a toy dopri5 solve at rtol = atol = 1e-4 per mode: NFE at most 1.3 x the
  bf16 field's and the solution within 0.05 of it; against JAX's host
  stage-delta solve the same NFE or one step attempt more or less, the
  solution within the int8 field rule;
- the defaults: ``anchored_vf_base`` and ``base_mlp_block`` called with
  their defaults write the same caches as JAX's called with theirs;
- the refusals, and ``sample_lfm --hidden_mode exact|gelu`` on the CPU.
"""

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
from uspace_tpu_torch.core import solvers as tsolvers
from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops.quant import quantize_colwise

TOY = dict(img_size=8, patch_size=4, in_chans=4, embed_dim=64, depth=2,
           num_heads=2)
C, L, EPS = 64, 5, 1e-5
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
INT8_TOL = {"f32": (2e-3, 1e-4), "bf16": (2e-2, 5e-3)}
# rows 24 and 25 against the JAX kernels: dg = gelu(e_b + de) - gelu(e_b)
# is a difference of two O(1) values of size O(de), so a one-ulp difference
# in its argument or in GELU (XLA on the CPU contracts e_b + de into a
# multiply-add and evaluates exp and the erf polynomial with its own
# operations; the kernels and the twins round each operation) moves dg by
# about 200 ulps of itself and flips a dg code now and then: rel-L2 3e-4 to
# 1.6e-3 on o - x - m_b in f32 over five seeds (row 23, with no GELU, reads
# 7e-6 where no LN code flips). So both dtypes take the bf16 rel-L2; f32
# keeps its max-abs
DELTA_TWIN_TOL = {"f32": (2e-3, 5e-3), "bf16": (2e-2, 5e-3)}
FLIP_RATE = 5e-3
FIELD_REL = 5e-2
SOLVE = dict(method="dopri5", rtol=1e-4, atol=1e-4, controller="i",
             safety=0.9)
MODES = ("exact", "gelu")
# the cache keys of each hidden mode's MLP half
HIDDEN_KEYS = {"exact": {"e_q", "e_s"},
               "gelu": {"e_q", "e_s", "g_q", "g_s", "g_z"}}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(port, ref, dt, base=None, tol=INT8_TOL):
    """The int8 tolerances: max-abs, and rel-L2 of ``x - base``."""
    atol, rtol = tol[dt]
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


def _both(a, dt):
    """numpy f32 -> (JAX array, torch tensor) in the dtype ``dt``."""
    jd, td = DT[dt]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# ---------------------------------------------------------------------------
# rows 20, 21, 24 and 25: the twins against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


def _weights(r, k, n, std):
    w = (r.standard_normal((k, n)) * std).astype(np.float32)
    jq, js = jquantize_colwise(jnp.asarray(w))
    tq, ts = quantize_colwise(torch.from_numpy(w))
    assert (np.asarray(jq) == tq.numpy()).all()
    return (jq, js), (tq, ts)


def _mlp_case(seed, dt, mode):
    """A base MLP half in ``mode`` on x_b from both packages, and a stage's
    x = x_b + 1e-2 n."""
    r = np.random.default_rng(seed)
    hidden = 4 * C
    xb = r.standard_normal((2, L, C)).astype(np.float32)
    x = xb + 1e-2 * r.standard_normal(xb.shape).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(C)).astype(np.float32)
    b = (0.1 * r.standard_normal(C)).astype(np.float32)
    (j1, js1), (t1, ts1) = _weights(r, C, hidden, 0.1)
    (j2, js2), (t2, ts2) = _weights(r, hidden, C, 0.05)
    b1 = (r.standard_normal(hidden) * 0.02).astype(np.float32)
    b2 = (r.standard_normal(C) * 0.02).astype(np.float32)
    jxb, txb = _both(xb, dt)
    jx, tx = _both(x, dt)
    jout = jdelta.base_mlp_block(
        jxb, jnp.asarray(s), jnp.asarray(b), j1, js1, jnp.asarray(b1), j2,
        js2, jnp.asarray(b2), EPS, interpret=True, mode=mode)
    targs = (torch.from_numpy(s), torch.from_numpy(b), t1, ts1,
             torch.from_numpy(b1), t2, ts2, torch.from_numpy(b2), EPS)
    tout = tdelta.base_mlp_block(txb, *targs, mode=mode)
    return SimpleNamespace(**locals())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["e", "e+g"])
def test_base_mlp_e_twin_matches_jax(dt, mode):
    """Rows 20 and 21 on every output, caches included."""
    k = _mlp_case(20, dt, mode)
    assert [tuple(t.shape) for t in k.tout] == [a.shape for a in k.jout]
    assert len(k.tout) == (7 if mode == "e+g" else 4)
    assert tuple(k.tout[2].shape) == (2 * L, 4)  # one scale per strip
    _close(k.tout[0], k.jout[0], dt, base=k.txb)
    _codes(k.tout[1], k.jout[1])
    _scales(k.tout[2], k.jout[2])
    _close(k.tout[3], k.jout[3], dt)
    if mode == "e+g":
        _codes(k.tout[4], k.jout[4])
        _scales(k.tout[5], k.jout[5])
        _scales(k.tout[6], k.jout[6])
    # the twin itself: rows 20 and 21 share everything but the extra outputs
    plain = tdelta.base_mlp_e_plain(k.txb.reshape(-1, C), *k.targs, 4,
                                    emit_gelu=True)
    assert all(torch.equal(a.reshape(b.shape), b)
               for a, b in zip(plain, k.tout))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("gelu", [False, True], ids=["exact", "gelu"])
def test_delta_mlp_twin_matches_jax(dt, gelu):
    """Rows 25 and 24 on JAX's own base cache, on what they add to it, at
    ``DELTA_TWIN_TOL``."""
    k = _mlp_case(21, dt, "e+g" if gelu else "e")
    jeq, jes, jm = k.jout[1], k.jout[2], k.jout[3]
    jgc = tuple(k.jout[4:]) if gelu else None
    jo = jdelta.delta_mlp_block(
        k.jx, k.jxb, jeq, jes, jm, jnp.asarray(k.s), jnp.asarray(k.b), k.j1,
        k.js1, k.j2, k.js2, EPS, interpret=True, gelu_cache=jgc)
    tm = _to_torch(jm)
    tgc = tuple(_to_torch(a) for a in jgc) if gelu else None
    to = tdelta.delta_mlp_block(
        k.tx, k.txb, _to_torch(jeq), _to_torch(jes), tm,
        torch.from_numpy(k.s), torch.from_numpy(k.b), k.t1, k.ts1, k.t2,
        k.ts2, EPS, gelu_cache=tgc)
    _close(to, jo, dt, base=k.tx.float() + tm.float(), tol=DELTA_TWIN_TOL)


@pytest.mark.parametrize("gelu", [False, True], ids=["exact", "gelu"])
def test_delta_mlp_zero_delta(gelu):
    """At the base's own point row 25 gives the base's output bit for bit
    (dg = 0); row 24 re-rounds the base's hidden residual, near it."""
    k = _mlp_case(22, "f32", "e+g" if gelu else "e")
    o, e_q, e_s, m = k.tout[:4]
    same = tdelta.delta_mlp_block(
        k.txb, k.txb, e_q, e_s, m, *k.targs[:4], *k.targs[5:7], EPS,
        gelu_cache=tuple(k.tout[4:]) if gelu else None)
    if gelu:
        assert _rel(same - k.txb, o - k.txb) < 5e-3
    else:
        assert torch.equal(same, o)


def test_twins_count_no_launches():
    tdelta.reset_launches()
    k = _mlp_case(23, "bf16", "e+g")
    tdelta.delta_mlp_block(k.tx, k.txb, *k.tout[1:4], *k.targs[:4],
                           *k.targs[5:7], EPS, gelu_cache=tuple(k.tout[4:]))
    assert set(tdelta.LAUNCHES.values()) == {0}


# each mode's fc1 entry and launch count (rows 25, 23 and 24)
DELTA_PIECES = {"exact": ("uspace_delta_fc1_exact", "delta_mlp_exact"),
                "grad": ("uspace_delta_fc1_lin", "delta_mlp_lin"),
                "gelu": ("uspace_delta_fc1_g", "delta_mlp_g")}


@pytest.mark.parametrize("mode", ["exact", "grad", "gelu"])
def test_row25_wrapper_runs_its_three_pieces(monkeypatch, mode):
    """Rows 25, 23 and 24's plumbing on the card with the library calls
    stubbed: row 19's code pass of x and x_b, the mode's fc1 with its dg
    epilogue reading the mode's cache (e_q, e_s; gp_q, gp_s; e_q, e_s, g_q,
    g_s, g_z) into an [R, hidden] int8 workspace with [R, strips] scales,
    fc2 reading that workspace, x and m_b into the output; one launch
    counted, under the mode's key."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, args))
                return 0
            return call

    monkeypatch.setattr(tdelta, "load", lambda name: Lib())
    monkeypatch.setattr(tdelta, "cuda_stream", lambda dev: None)
    r, c, hidden, strips = 10, 256, 1024, 4
    rng = np.random.default_rng(24)
    x, xb, mb = (torch.from_numpy(rng.standard_normal((r, c)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    (_, _), (t1, ts1) = _weights(rng, c, hidden, 0.1)
    (_, _), (t2, ts2) = _weights(rng, hidden, c, 0.05)
    c_q = torch.zeros((r, hidden), dtype=torch.int8)
    c_s = torch.ones((r, strips))
    gc = ((torch.zeros((r, hidden), dtype=torch.int8), torch.ones((r, strips)),
           torch.zeros((r, strips))) if mode == "gelu" else None)
    one = torch.ones(c)
    tdelta.reset_launches()
    o = tdelta._delta_mlp_kernel(x, xb, c_q, c_s, gc, mb, one, one, t1,
                                 ts1, t2, ts2, EPS, strips, mode == "grad")
    assert o.shape == x.shape
    fc1_name, key = DELTA_PIECES[mode]
    assert [fn for fn, _ in calls] == ["uspace_ln_delta_codes", fc1_name,
                                       "uspace_delta_fc2"]
    codes, fc1, fc2 = (args for _, args in calls)
    assert codes[:2] == (x.data_ptr(), xb.data_ptr()) and codes[6:8] == (r, c)
    cache = (c_q, c_s) + (gc or ())
    n = 4 + len(cache)
    assert fc1[:2] == codes[4:6]
    assert fc1[4:n] == tuple(t.data_ptr() for t in cache)
    assert fc1[n + 2:n + 6] == (r, c, hidden, strips)
    assert fc2[:2] == fc1[n:n + 2]  # the hidden codes and their scales
    assert fc2[4:7] == (mb.data_ptr(), x.data_ptr(), o.data_ptr())
    assert fc2[7:11] == (r, c, hidden, strips)
    assert tdelta.LAUNCHES[key] == 1
    assert sum(tdelta.LAUNCHES.values()) == 1


# ---------------------------------------------------------------------------
# the field against the JAX field
# ---------------------------------------------------------------------------


def _build_toy(dt):
    """The JAX toy field (f32 params), its base and delta jitted on demand
    per (hidden mode, fused), and the port's field on the same weights."""
    jd, td = DT[dt]
    jm = JaxUViT(dtype=jd, **TOY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                     jnp.zeros((1,)))
    dp = jdf.prepare_delta_params(params)
    jits = {}

    def jit(mode, fused):
        if (mode, fused) not in jits:
            jits[mode, fused] = (
                jax.jit(lambda dp, t, x: jdf.anchored_vf_base(
                    jm, dp, t, x, fused=fused, hidden_mode=mode)),
                jax.jit(lambda dp, t, x, c: jdf.anchored_vf_delta(
                    jm, dp, t, x, c, fused=fused)))
        return jits[mode, fused]

    tm = load_uvit_from_jax(UViT(dtype=td, param_dtype=torch.float32,
                                 device="cpu", **TOY),
                            jax.tree.map(np.asarray, params))
    return SimpleNamespace(jm=jm, params=params, dp=dp, jit=jit, tm=tm,
                           tdp=tdf.prepare_delta_params(tm))


@pytest.fixture(scope="module")
def toys():
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


def _base(toy, t, z, mode, fused=True):
    with torch.no_grad():
        return tdf.anchored_vf_base(toy.tm, toy.tdp, torch.tensor(t),
                                    torch.from_numpy(z), fused=fused,
                                    hidden_mode=mode)


def _delta(toy, t, z, cache, fused=True):
    with torch.no_grad():
        return tdf.anchored_vf_delta(toy.tm, toy.tdp, torch.tensor(t),
                                     torch.from_numpy(z), cache, fused=fused)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt,fused", [("bf16", True), ("bf16", False),
                                      ("f32", True), ("f32", False)])
def test_base_field_matches_jax(toys, mode, dt, fused):
    """bf16: the whole-field rule; f32: the per-call int8 tolerance. The
    caches hold JAX's keys and shapes: per row and strip fused, per whole
    row unfused."""
    toy = toys(dt)
    z = _z(30)
    fj, cj = toy.jit(mode, fused)[0](toy.dp, jnp.float32(0.3),
                                     jnp.asarray(z))
    ft, ct = _base(toy, 0.3, z, mode, fused)
    assert ft.dtype == torch.float32 and tuple(ft.shape) == z.shape
    if dt == "bf16":
        assert _rel(ft, fj) < FIELD_REL
    else:
        _close(ft, fj, dt)
    assert set(ct) == set(cj)
    for name in tdf._block_names(toy.tm.depth):
        assert set(ct[name]) == set(cj[name])
        assert HIDDEN_KEYS[mode] <= set(ct[name])
        for k, v in ct[name].items():
            assert tuple(v.shape) == cj[name][k].shape, (name, k)
    assert ct["mid_block"]["e_s"].shape[-1] == (4 if fused else 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt,fused", [("bf16", True), ("f32", True),
                                      ("f32", False)])
def test_delta_on_jax_cache_matches_jax(toys, mode, dt, fused):
    """The port's delta and JAX's on JAX's own cache, at a stage's
    distance: the per-call int8 tolerance on the velocity (the unfused bf16
    delta is held by the field rule only, as in test_torch_delta.py)."""
    toy = toys(dt)
    base, delta = toy.jit(mode, fused)
    z = _z(31)
    _, cj = base(toy.dp, jnp.float32(0.3), jnp.asarray(z))
    z1 = z + 0.02 * _z(32)
    fj = delta(toy.dp, jnp.float32(0.32), jnp.asarray(z1), cj)
    ft = _delta(toy, 0.32, z1, _cache_to_torch(cj), fused=fused)
    _close(ft, fj, dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [True, False])
def test_zero_distance_delta(toy, mode, fused):
    """``"exact"``: bit for bit (dg = gelu(e_b) - gelu(e_b) = 0); ``"gelu"``:
    within the base's own int8 floor (tests/test_delta_field.py:111)."""
    z = _z(33)
    f0, cache = _base(toy, 0.5, z, mode, fused)
    fd = _delta(toy, 0.5, z, cache, fused)
    if mode == "exact":
        assert torch.equal(fd, f0)
    else:
        assert _rel(fd, f0) < 5e-3


def test_gelu_zero_delta_at_uvit_large_width():
    """The ``"gelu"`` delta at the base's own point adds back W2 q8(r), r =
    gelu(e_b) - deq(g_q) the base's affine hidden rounding, whose weight
    grows with the hidden width: at U-ViT-large's width (embed 1024, hidden
    4096, 16 heads; depth 2, bf16) JAX's own field reads above the 5e-3 that
    its toy test holds at embed 64, and the port reads what JAX reads (within
    a quarter), both under chip_smoke.py's phase-23 limit of 1.5e-2."""
    kw = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=1024, depth=2,
              num_heads=16)
    jm = JaxUViT(dtype=jnp.bfloat16, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                              jnp.zeros((1,)))
    dp = jdf.prepare_delta_params(params)
    z = _z(42)
    f0, cache = jax.jit(lambda dp, t, x: jdf.anchored_vf_base(
        jm, dp, t, x, hidden_mode="gelu"))(dp, jnp.float32(0.5),
                                             jnp.asarray(z))
    fd = jax.jit(lambda dp, t, x, c: jdf.anchored_vf_delta(jm, dp, t, x, c))(
        dp, jnp.float32(0.5), jnp.asarray(z), cache)
    rel_jax = _rel(fd, f0)
    tm = load_uvit_from_jax(UViT(dtype=torch.bfloat16,
                                 param_dtype=torch.float32, device="cpu",
                                 **kw), jax.tree.map(np.asarray, params))
    toy = SimpleNamespace(tm=tm, tdp=tdf.prepare_delta_params(tm))
    g0, tcache = _base(toy, 0.5, z, "gelu")
    rel_port = _rel(_delta(toy, 0.5, z, tcache), g0)
    assert 5e-3 < rel_jax < 1.5e-2, rel_jax
    assert abs(rel_port - rel_jax) <= 0.25 * rel_jax, (rel_port, rel_jax)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [True, False])
def test_delta_tracks_full(toy, mode, fused):
    z0 = _z(34)
    _, cache = _base(toy, 0.3, z0, mode, fused)
    z1 = z0 + 0.02 * _z(35)
    f1 = _delta(toy, 0.32, z1, cache, fused)
    f1_full, _ = _base(toy, 0.32, z1, mode, fused)
    assert _rel(f1, f1_full) < 0.04


@pytest.mark.parametrize("mode", MODES)
def test_fused_matches_unfused(toy, mode):
    z = _z(36)
    ff, cf = _base(toy, 0.4, z, mode)
    fu, cu = _base(toy, 0.4, z, mode, fused=False)
    assert set(cf) == set(cu)
    assert _rel(ff, fu) < 0.03
    z1 = z + 0.03 * _z(37)
    assert _rel(_delta(toy, 0.42, z1, cf),
                _delta(toy, 0.42, z1, cu, fused=False)) < 0.03


def test_defaults_match_jax(toy):
    """``anchored_vf_base`` and ``base_mlp_block`` with their defaults: the
    same cache keys as JAX's with theirs (the ``"exact"`` mode, ``mode="e"``),
    within the whole-field rule and the per-call tolerances."""
    z = _z(38)
    fj, cj = jax.jit(lambda dp, t, x: jdf.anchored_vf_base(toy.jm, dp, t, x))(
        toy.dp, jnp.float32(0.3), jnp.asarray(z))
    with torch.no_grad():
        ft, ct = tdf.anchored_vf_base(toy.tm, toy.tdp, torch.tensor(0.3),
                                      torch.from_numpy(z))
    assert {n: set(c) for n, c in ct.items() if isinstance(c, dict)} == \
        {n: set(c) for n, c in cj.items() if isinstance(c, dict)}
    assert HIDDEN_KEYS["exact"] <= set(ct["mid_block"])
    assert _rel(ft, fj) < FIELD_REL
    r = np.random.default_rng(39)
    x = r.standard_normal((2, L, C)).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(C)).astype(np.float32)
    b = (0.1 * r.standard_normal(C)).astype(np.float32)
    (j1, js1), (t1, ts1) = _weights(r, C, 4 * C, 0.1)
    (j2, js2), (t2, ts2) = _weights(r, 4 * C, C, 0.05)
    b1 = (r.standard_normal(4 * C) * 0.02).astype(np.float32)
    b2 = (r.standard_normal(C) * 0.02).astype(np.float32)
    jout = jdelta.base_mlp_block(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), j1, js1,
        jnp.asarray(b1), j2, js2, jnp.asarray(b2), EPS, interpret=True)
    tout = tdelta.base_mlp_block(
        torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), t1,
        ts1, torch.from_numpy(b1), t2, ts2, torch.from_numpy(b2), EPS)
    assert [tuple(t.shape) for t in tout] == [a.shape for a in jout]
    _close(tout[0], jout[0], "f32", base=torch.from_numpy(x))
    _codes(tout[1], jout[1])
    _scales(tout[2], jout[2])
    _close(tout[3], jout[3], "f32")


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_solve(toy):
    z = _z(40)

    def vf(t, x):
        return toy.tm(x, torch.full((x.shape[0],), float(t)))[0].float()

    with torch.no_grad():
        return z, tsolvers.odeint_adaptive(vf, torch.from_numpy(z), 0.0, 1.0,
                                           return_stats=True, **SOLVE)


@pytest.mark.parametrize("mode", MODES)
def test_stage_delta_solve_keeps_nfe_and_matches_jax_host(toy, bf16_solve,
                                                          mode):
    z, (x_bf, s_bf) = bf16_solve
    pair = tdf.make_delta_field(toy.tm, toy.tdp, hidden_mode=mode)
    with torch.no_grad():
        x_d, s_d = tsolvers.odeint_adaptive(None, torch.from_numpy(z), 0.0,
                                            1.0, return_stats=True,
                                            stage_delta=pair, **SOLVE)
    assert s_d["t"] == 1.0 and bool(torch.isfinite(x_d).all())
    assert s_d["nfe"] == 2 + 6 * s_d["steps"]
    assert s_d["nfe"] <= 1.3 * s_bf["nfe"]
    assert _rel(x_d, x_bf) < 0.05

    fb = lambda t, x, p: jdf.anchored_vf_base(  # noqa: E731
        toy.jm, p, t, x, fused=True, hidden_mode=mode)
    fd = lambda t, x, c, p: jdf.anchored_vf_delta(  # noqa: E731
        toy.jm, p, t, x, c, fused=True)
    x_j, s_j = jsolvers.odeint_adaptive_host(
        None, jnp.asarray(z), 0.0, 1.0, return_stats=True, program="stages",
        vf_params=toy.dp, stage_delta=(fb, fd), **SOLVE)
    assert abs(int(s_j["nfe"]) - s_d["nfe"]) <= 6
    assert abs(int(s_j["steps"]) - s_d["steps"]) <= 1
    assert _rel(x_d, x_j) < FIELD_REL


# ---------------------------------------------------------------------------
# refusals and the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["e_s", "g_s", "contradiction", "typo"])
def test_refusals(case):
    """Per-row scales where the fused delta reads one per row and strip, the
    contradiction of ``grad=True`` with a gelu cache, a typo of the mode:
    each raises before any compute."""
    k = _mlp_case(41, "bf16", "e+g")
    _, e_q, e_s, m, g_q, g_s, g_z = k.tout
    dargs = (k.tx, k.txb, e_q, e_s, m, *k.targs[:4], *k.targs[5:7], EPS)
    row = e_s[:, :1].contiguous()
    err, match, call = ValueError, "must hold one scale per row and strip", {
        "e_s": lambda: tdelta.delta_mlp_block(*dargs[:3], row, *dargs[4:]),
        "g_s": lambda: tdelta.delta_mlp_block(*dargs,
                                              gelu_cache=(g_q, row, g_z)),
        "contradiction": lambda: tdelta.delta_mlp_block(
            *dargs, gelu_cache=(g_q, g_s, g_z), grad=True),
        "typo": lambda: tdf.anchored_vf_base(None, None, None, None,
                                             hidden_mode="gleu"),
    }[case]
    if case == "contradiction":
        match = "contradict"
    elif case == "typo":
        match = "hidden_mode"
    with pytest.raises(err, match=match):
        call()


@pytest.mark.parametrize("mode", MODES)
def test_sample_lfm_hidden_mode_on_cpu(mode, tmp_path, capsys):
    """``--hidden_mode exact|gelu``: one adaptive batch through the twins,
    the same latents as the config's ``sample.solver_kwargs.hidden_mode``."""
    sample_lfm.main(["--config", "synthetic_smoke", "--device", "cpu",
                     "--solver", "adaptive", "--field", "stage_delta_int8",
                     "--hidden_mode", mode, "--rtol", "1e-3", "--atol",
                     "1e-3", "--n_samples", "2", "--batch", "2", "--out",
                     str(tmp_path / "a")])
    assert "NFE" in capsys.readouterr().out
    a = np.load(tmp_path / "a" / "0.npy")
    assert a.shape == (2, 8, 8, 4) and np.isfinite(a).all()
    cfg = get_config("synthetic_smoke")
    cfg["sample"]["solver_kwargs"].update(
        solver="adaptive", field="stage_delta_int8", hidden_mode=mode,
        rtol=1e-3, atol=1e-3)
    st = []
    sample_lfm.run(config=cfg, n_samples=2, batch=2, device="cpu",
                   out=str(tmp_path / "b"), stats=st)
    np.testing.assert_array_equal(a, np.load(tmp_path / "b" / "0.npy"))
    assert st[0]["nfe"] == 2 + 6 * st[0]["steps"]
