"""uspace_tpu_torch.ops: each kernel's plain twin held to the JAX kernel.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_quant.py does; the port's wrappers take their plain twins for
CPU tensors. Gradients: ``jax.vjp`` of the JAX function (its custom VJP
runs ``_packed_bwd_kernel`` in interpret mode) against port autograd.
Inputs come from numpy seeds. Tolerances: f32 1e-5 (the same arithmetic,
summed in another order), bf16 2e-2 (one bf16 rounding of an O(1) value is
8e-3).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.ops import attention as jattn
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu_torch.ops import _build
from uspace_tpu_torch.ops import attention as tattn
from uspace_tpu_torch.ops import mlp as tmlp

B, L, C, H = 2, 17, 64, 4  # ragged L: the TPU kernels pad it to 32 and mask
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(
        qkv=r.standard_normal((B, L, 3 * C)).astype(np.float32),
        x=r.standard_normal((B, L, C)).astype(np.float32),
        w=(r.standard_normal((C, 3 * C)) * 0.2).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(C)).astype(np.float32),
        b=(0.1 * r.standard_normal(C)).astype(np.float32),
    )


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_packed_twin_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    a = _inputs()
    ref = jattn.fused_qkv_attention(jnp.asarray(a["qkv"], jd), H,
                                    interpret=True)
    out = tattn.fused_qkv_attention(torch.from_numpy(a["qkv"]).to(td), H)
    assert out.dtype == td and out.shape == (B, L, C)
    _close(out, ref, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_qkvproj_twin_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    a = _inputs(1)
    ref = jattn.fused_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["w"]), H, interpret=True)
    out = tattn.fused_qkvproj_attention(torch.from_numpy(a["x"]).to(td),
                                        torch.from_numpy(a["w"]), H)
    assert out.dtype == td
    _close(out, ref, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_qkvproj_twin_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    a = _inputs(2)
    ref = jattn.fused_ln_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w"]), H, quant=False, interpret=True)
    out = tattn.fused_ln_qkvproj_attention(
        torch.from_numpy(a["x"]).to(td), torch.from_numpy(a["s"]),
        torch.from_numpy(a["b"]), torch.from_numpy(a["w"]), H)
    _close(out, ref, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_rows_then_qkvproj_is_the_ln_twin(dt):
    """The card's bf16 LN route runs the LN pass, then the projection and
    the core: their twins in that order give the LN twin (held to JAX
    above) bit for bit. The LN pass's own sums in lane order
    (``delta.ln_lanes``, which the kernel equals bit for bit on the card)
    stay within the file's tolerance of :func:`ln_rows_plain`."""
    from uspace_tpu_torch.ops import delta as tdelta
    _, td, tol = DTYPES[dt]
    a = _inputs(3)
    x = torch.from_numpy(a["x"] * 3 + 0.5).to(td)
    s, b, w = (torch.from_numpy(a[k]) for k in ("s", "b", "w"))
    rows = tattn.ln_rows_plain(x, s, b, 1e-5)
    assert rows.dtype == td and rows.shape == x.shape
    assert torch.equal(
        tattn.qkvproj_attention_plain(rows, w, H, 0.125),
        tattn.ln_qkvproj_attention_plain(x, s, b, w, H, 0.125, 1e-5))
    _close(tdelta.ln_lanes(x, s, b, 1e-5).to(td), rows, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_xla_attention_and_col_mult_match_jax(dt):
    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal((B, H, L, 16)).astype(np.float32)
               for _ in range(3))
    m = (1 + 0.5 * r.random((B, L))).astype(np.float32)
    ref, ref_p = jattn.multi_head_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), col_mult=jnp.asarray(m),
        return_probs=True)
    out, p = tattn.multi_head_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        col_mult=torch.from_numpy(m), return_probs=True)
    _close(out, ref, tol)
    _close(p, ref_p, 1e-5)
    ref = jattn.multi_head_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    out = tattn.multi_head_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), impl="xla")
    _close(out, ref, tol)


@pytest.mark.parametrize("l,d", [(130, 32), (130, 64), (600, 32),
                                 (600, 64)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fwd_twin_matches_jax(dt, l, d):
    """Kernel 7's twin (multi_head_attention impl="pallas": the wrapper's
    CPU route) against JAX's _fused_attention, whose _fwd_kernel runs in
    interpret mode on the CPU; ragged L (padded to 32 and masked)."""
    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(l + d)
    q, k, v = (r.standard_normal((1, 2, l, d)).astype(np.float32)
               for _ in range(3))
    ref = jattn.multi_head_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                     impl="pallas")
    out = tattn.multi_head_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), impl="pallas")
    assert out.dtype == td and out.shape == (1, 2, l, d)
    _close(out, ref, tol)
    # the twin itself, and auto on the CPU (plain math) within the dtype's
    # tolerance of it
    _close(tattn.attention_plain(*(torch.from_numpy(a).to(td)
                                   for a in (q, k, v)), d ** -0.5), ref, tol)
    _close(tattn.multi_head_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v))), ref, tol)


def _two_pass_fwd(q, k, v, scale, tile=256):
    """A mirror of the [B, H, L, D] forward kernel's arithmetic (row 7):
    pass 1 takes the extreme of the raw scores over every 256-key tile (the
    max, or the least score for a negative scale); m = RN(extreme * c) with
    c = RN(scale * log2(e)); pass 2 forms p = 2^(s c - m) (one rounding, as
    the kernel's FFMA) in f32 against the whole row's max, sums it in f32
    and rounds it once to bf16 for P V; O is divided by l once. Only f32
    values move against the twin (the exponential's), never a rounding
    site."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    n = q.shape[2]
    tiles = [slice(t0, min(t0 + tile, n)) for t0 in range(0, n, tile)]
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    pick = torch.amax if float(c) >= 0 else torch.amin
    x = None
    for ks in tiles:
        s = torch.matmul(qf, kf[:, :, ks].transpose(-1, -2))
        e = pick(s, dim=-1, keepdim=True)
        x = e if x is None else pick(torch.cat([x, e], dim=-1), dim=-1,
                                     keepdim=True)
    m = x * c
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for ks in tiles:
        s = torch.matmul(qf, kf[:, :, ks].transpose(-1, -2))
        p = torch.exp2((s.double() * c.double() - m.double()).float())
        l = l + p.sum(dim=-1, keepdim=True)
        o = o + torch.matmul(p.to(v.dtype).float(), vf[:, :, ks])
    return (o / l).to(q.dtype)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("l,d", [(130, 32), (600, 64)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_two_pass_forward_keeps_the_rounding_sites(dt, l, d, sign):
    """Row 7's folded two-pass arithmetic against JAX's _fused_attention
    (multi_head_attention impl="pallas", whose _fwd_kernel runs in
    interpret mode on the CPU) and against the twin attention_plain, at
    ragged L and either sign of the scale: f32 within 1e-5, bf16 within the
    file's bf16 tolerance."""
    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(l + d + int(sign))
    q, k, v = (r.standard_normal((1, 2, l, d)).astype(np.float32)
               for _ in range(3))
    scale = sign * d ** -0.5
    ref = jattn.multi_head_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                     scale=scale, impl="pallas")
    ts = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    mine = _two_pass_fwd(*ts, scale)
    assert mine.dtype == td and mine.shape == (1, 2, l, d)
    _close(mine, ref, tol)
    _close(mine, tattn.attention_plain(*ts, scale), tol)


def _vjp_inputs(l, seed):
    """qkv, cotangent and projection operands at 2 heads of 64."""
    r = np.random.default_rng(seed)
    c = 128
    return dict(qkv=(0.5 * r.standard_normal((2, l, 3 * c))).astype(np.float32),
                g=r.standard_normal((2, l, c)).astype(np.float32),
                x=r.standard_normal((2, l, c)).astype(np.float32),
                w=(r.standard_normal((c, 3 * c)) * c ** -0.5).astype(np.float32))


@pytest.mark.parametrize("l", [17, 257])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_packed_vjp_matches_jax(dt, l):
    """Port autograd of fused_qkv_attention (the backward twin) vs the JAX
    custom VJP (_packed_bwd_kernel, interpret mode)."""
    jd, td, tol = DTYPES[dt]
    a = _vjp_inputs(l, 4)
    out_j, vjp = jax.vjp(
        lambda q: jattn.fused_qkv_attention(q, 2, interpret=True),
        jnp.asarray(a["qkv"], jd))
    (ref,) = vjp(jnp.asarray(a["g"], jd))
    qkv = torch.from_numpy(a["qkv"]).to(td).requires_grad_()
    out = tattn.fused_qkv_attention(qkv, 2)
    out.backward(torch.from_numpy(a["g"]).to(td))
    assert qkv.grad.dtype == td and qkv.grad.shape == qkv.shape
    _close(out.detach(), out_j, tol)
    _close(qkv.grad, ref, tol)
    # the public backward entry point is the same twin
    _close(tattn.packed_attention_bwd(qkv.detach(), torch.from_numpy(
        a["g"]).to(td), 2), ref, tol)


@pytest.mark.parametrize("l,d", [(64, 32), (64, 64), (130, 32), (130, 64),
                                 (600, 32), (600, 64)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_vjp_matches_jax(dt, l, d):
    """Port autograd of fused_attention (kernel 8's twin as the VJP of
    kernel 7's twin) vs jax.vjp of multi_head_attention(impl="pallas"),
    whose custom VJP runs _bwd_kernel in interpret mode; ragged L is padded
    to 32 and masked there. f32 within 1e-5; bf16 within one bf16 step of
    each output's largest value (JAX on the CPU keeps bf16 chains in f32,
    so a rounding may fall on the other side)."""
    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(l + d + 7)
    q, k, v, g = (r.standard_normal((1, 2, l, d)).astype(np.float32)
                  for _ in range(4))
    out_j, vjp = jax.vjp(
        lambda q, k, v: jattn.multi_head_attention(q, k, v, impl="pallas"),
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    refs = vjp(jnp.asarray(g, jd))
    ts = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = tattn.fused_attention(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g).to(td))
    # the public backward entry point is the same twin
    direct = tattn.fused_attention_bwd(*(t.detach() for t in ts),
                                       torch.from_numpy(g).to(td))
    _close(out.detach(), out_j, tol)
    for mine, again, ref in zip(grads, direct, refs):
        assert mine.dtype == td and mine.shape == (1, 2, l, d)
        assert torch.equal(mine, again)
        top = float(np.abs(_np(ref)).max())
        _close(mine, ref, tol if dt == "f32"
               else 2.0 ** (math.floor(math.log2(top)) - 7))


def test_fused_vjp_is_not_autograd_of_the_forward_twin():
    """The Function's backward is the JAX VJP's arithmetic (P normalised in
    f32 before its bf16 cast, delta from P and dP), not autograd of the
    forward twin, and it saves only q, k and v."""
    r = np.random.default_rng(9)
    q, k, v, g = (torch.from_numpy(r.standard_normal((1, 2, 130, 32)).astype(
        np.float32)).bfloat16() for _ in range(4))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.fused_attention(*ts)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(saved, (q, k, v)))
    mine = torch.autograd.grad(out, ts, g)
    ts2 = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(tattn.attention_plain(*ts2, 32 ** -0.5), ts2, g)
    twin = tattn.attention_bwd_plain(q, k, v, g, 32 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(mine, twin))
    assert not all(torch.equal(a, b) for a, b in zip(mine, auto))


def _two_pass_bwd(q, k, v, do, scale, tile=64):
    """A mirror of the backward kernels' pass structure (rows 4 and 8, one
    body on two layouts): pass 1 over 64-key tiles keeps a running max m
    with l = sum exp(s - m) and u = sum exp(s - m) dP, both rescaled by
    exp(m_old - m_new) when m grows, and delta = u / l; pass 2 recomputes S
    and dP per tile, forms p = exp(s - m) / l and dS = bf16(p (dP - delta))
    and accumulates dQ; dK and dV take p and dS from the same m, l and
    delta. A last tile of at most 16 keys is the kernels' 16-key chunk: the
    slice ends at L either way, as the chunk's masked keys add nothing. Only
    f32 sums are reordered against the twin; every bf16 rounding sits where
    it does."""
    qf, kf, vf, g = (t.float() for t in (q, k, v, do))
    n = q.shape[2]
    m = torch.full(q.shape[:3] + (1,), -0.7 * torch.finfo(torch.float32).max)
    l = torch.zeros_like(m)
    u = torch.zeros_like(m)
    tiles = [slice(t0, min(t0 + tile, n)) for t0 in range(0, n, tile)]
    for ks in tiles:
        s = torch.matmul(qf, kf[:, :, ks].transpose(-1, -2)) * scale
        dp = torch.matmul(g, vf[:, :, ks].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        a = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * a + e.sum(dim=-1, keepdim=True)
        u = u * a + (e * dp).sum(dim=-1, keepdim=True)
        m = m_new
    delta = u / l
    dq = torch.zeros_like(qf)
    for ks in tiles:
        s = torch.matmul(qf, kf[:, :, ks].transpose(-1, -2)) * scale
        dp = torch.matmul(g, vf[:, :, ks].transpose(-1, -2))
        p = torch.exp(s - m) / l
        ds = (p * (dp - delta)).to(q.dtype).float()
        dq = dq + torch.matmul(ds, kf[:, :, ks])
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - m) / l
    dp = torch.matmul(g, vf.transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), g)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return tuple(t.to(q.dtype) for t in (dq * scale, dk, dv))


def _packed_two_pass_bwd(qkv, do, heads):
    """:func:`_two_pass_bwd` on the packed layout (row 4): qkv [B, L, 3HD]
    and do [B, L, HD] viewed per head, dqkv repacked as the kernel stores
    it."""
    b, l, c3 = qkv.shape
    d = c3 // (3 * heads)
    q, k, v = qkv.reshape(b, l, 3, heads, d).permute(2, 0, 3, 1, 4)
    g = do.reshape(b, l, heads, d).transpose(1, 2)
    dqkv = torch.stack(_two_pass_bwd(q, k, v, g, d ** -0.5))
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, l, c3)


# row 8 ([B, H, L, D]) at three lengths and both head dims; row 4 (packed,
# D = 64) at a ragged L and at the U-ViT's 257 (a 16-key last chunk)
TWO_PASS_CASES = ([("bhld", l, d) for l in (64, 130, 600) for d in (32, 64)]
                  + [("packed", l, 64) for l in (17, 257)])


@pytest.mark.parametrize("layout,l,d", TWO_PASS_CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_two_pass_backward_keeps_the_rounding_sites(dt, layout, l, d):
    """The backward kernels' pass merge (a running max with l and u
    rescaled, delta = u / l) against jax.vjp of the JAX function whose
    custom VJP runs the TPU kernel in interpret mode (row 8:
    multi_head_attention(impl="pallas"), _bwd_kernel; row 4:
    fused_qkv_attention, _packed_bwd_kernel, H = 2), and against the twin
    (attention_bwd_plain, packed_attention_bwd_plain): f32 within 1e-5;
    bf16 within one bf16 step of each output's largest value
    (test_fused_vjp_matches_jax's rule)."""
    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(l + 3 * d)
    if layout == "packed":
        heads = 2
        qkv, g = (r.standard_normal((2, l, n * heads * d)).astype(np.float32)
                  for n in (3, 1))
        _, vjp = jax.vjp(
            lambda t: jattn.fused_qkv_attention(t, heads, interpret=True),
            jnp.asarray(qkv, jd))
        refs = vjp(jnp.asarray(g, jd))
        ts = [torch.from_numpy(a).to(td) for a in (qkv, g)]
        mine = (_packed_two_pass_bwd(*ts, heads),)
        twin = (tattn.packed_attention_bwd_plain(*ts, heads, d ** -0.5),)
        shape = qkv.shape
    else:
        q, k, v, g = (r.standard_normal((1, 2, l, d)).astype(np.float32)
                      for _ in range(4))
        _, vjp = jax.vjp(
            lambda q, k, v: jattn.multi_head_attention(q, k, v, impl="pallas"),
            *(jnp.asarray(a, jd) for a in (q, k, v)))
        refs = vjp(jnp.asarray(g, jd))
        ts = [torch.from_numpy(a).to(td) for a in (q, k, v, g)]
        mine = _two_pass_bwd(*ts, d ** -0.5)
        twin = tattn.attention_bwd_plain(*ts, d ** -0.5)
        shape = (1, 2, l, d)
    for out, ref, plain in zip(mine, refs, twin):
        assert out.dtype == td and out.shape == shape
        for other in (ref, plain):
            top = float(np.abs(_np(other)).max())
            _close(out, other, tol if dt == "f32"
                   else 2.0 ** (math.floor(math.log2(top)) - 7))


@pytest.mark.parametrize("l", [17, 257])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_qkvproj_vjp_matches_jax(dt, l):
    """dx and dW of fused_qkvproj_attention vs the JAX _qkv_attn_bwd; W
    enters in f32 and is cast to x's dtype, as the model passes it."""
    jd, td, tol = DTYPES[dt]
    a = _vjp_inputs(l, 5)
    _, vjp = jax.vjp(
        lambda x, w: jattn.fused_qkvproj_attention(x, w.astype(jd), 2,
                                                   interpret=True),
        jnp.asarray(a["x"], jd), jnp.asarray(a["w"]))
    ref_dx, ref_dw = vjp(jnp.asarray(a["g"], jd))
    x = torch.from_numpy(a["x"]).to(td).requires_grad_()
    w = torch.from_numpy(a["w"]).requires_grad_()
    tattn.fused_qkvproj_attention(x, w, 2).backward(
        torch.from_numpy(a["g"]).to(td))
    assert x.grad.dtype == td and w.grad.dtype == torch.float32
    _close(x.grad, ref_dx, tol)
    # each dW entry sums B*L products (|dW| up to ~8 at L = 257, where one
    # bf16 ulp is 0.03-0.06): the tolerance scales with the largest entry
    _close(w.grad, ref_dw, tol * max(1.0, float(np.abs(_np(ref_dw)).max())))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_gelu_grad_matches_jax_autodiff(dt):
    """The GELU Function's backward vs jax.grad of layers.gelu_exact (the
    autodiff of the same polynomial), x = 0 included."""
    from uspace_tpu.models import layers as jlayers

    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(6)
    x = np.concatenate([np.linspace(-6, 6, 1001), [0.0],
                        3 * r.standard_normal(1000)]).astype(np.float32)
    g = r.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(jlayers.gelu_exact, jnp.asarray(x, jd))
    (ref,) = vjp(jnp.asarray(g, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    tmlp.gelu_exact(xt).backward(torch.from_numpy(g).to(td))
    assert xt.grad.dtype == td
    _close(xt.grad, ref, tol)


@pytest.mark.parametrize("td", [torch.float32, torch.bfloat16])
def test_gelu_forward_is_the_plain_polynomial(td):
    """The autograd Function leaves the forward bit for bit as the eager
    polynomial, so sampling does not move."""
    x = torch.from_numpy(np.linspace(-8, 8, 4001).astype(np.float32)).to(td)
    xf = x.float()
    plain = (0.5 * xf * (1.0 + tmlp.erf_poly(xf * 0.7071067811865476))).to(td)
    assert torch.equal(tmlp.gelu_exact(x), plain)


def test_gelu_matches_jax_polynomial():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(tmlp.gelu_exact(torch.from_numpy(x)),
           jmlp._gelu_exact(jnp.asarray(x)), 1e-6)
    _close(tmlp.erf_poly(torch.from_numpy(x)),
           jmlp._erf_poly(jnp.asarray(x)), 1e-6)


def test_unported_paths_raise():
    a = _inputs()
    x, w = torch.from_numpy(a["x"]), torch.from_numpy(a["w"])
    # the int8 kernels are ported but inference-only, as in the JAX package
    w.requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tattn.fused_qkvproj_attention(x, w, H, quant=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tattn.fused_ln_qkvproj_attention(x, x[0, 0], x[0, 0], w, H,
                                         quant=True)
    # kernel 7 runs at every L <= 1024 through "pallas" (its twin here)
    q = torch.zeros(1, H, 8, 16)
    assert tattn.multi_head_attention(q, q, q, impl="pallas").shape == q.shape
    # above 1024 "pallas" runs the blocked kernel 9 (its twin here), which
    # has no backward, as in the JAX package
    long = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 1, 1025, 32)).astype(np.float32))
    assert torch.equal(tattn.multi_head_attention(long, long, long,
                                                  impl="pallas"),
                       tattn.flash_attention_plain(long, long, long,
                                                   32 ** -0.5))
    with pytest.raises(ValueError, match="no backward"):
        tattn.multi_head_attention(long.requires_grad_(), long, long,
                                   impl="pallas")
    # kernel 7 is differentiable through kernel 8 (their twins here)
    qg = torch.zeros(1, 1, 600, 32, requires_grad=True)
    tattn.multi_head_attention(qg, qg, qg, impl="pallas").sum().backward()
    assert qg.grad.shape == qg.shape and torch.isfinite(qg.grad).all()
    with torch.no_grad():
        tattn.fused_attention(qg, qg, qg)
    with pytest.raises(ValueError, match="unknown impl"):
        tattn.multi_head_attention(q, q, q, impl="nope")


def test_cpu_twin_does_not_count_launches():
    tattn.reset_launches()
    a = _inputs()
    tattn.fused_qkv_attention(torch.from_numpy(a["qkv"]), H)
    tattn.fused_qkvproj_attention(torch.from_numpy(a["x"]),
                                  torch.from_numpy(a["w"]), H)
    qkv = torch.from_numpy(a["qkv"])
    tattn.packed_attention_bwd(qkv, qkv[..., :C], H)
    q = torch.zeros(1, 2, 600, 32)
    tattn.fused_attention(q, q, q)
    tattn.fused_attention_bwd(q, q, q, q)
    tattn.flash_attention_blocked(q, q, q)
    assert set(tattn.LAUNCHES.values()) == {0}
    assert {"packed_attention_bwd", "attention_fwd", "fused_attention_bwd",
            "flash"} <= set(tattn.LAUNCHES)


def test_kernel_input_checks():
    """What the CUDA wrappers refuse, checked before any launch."""
    ok = torch.zeros(2, 257, 1024, dtype=torch.bfloat16)
    tattn._check_x("x", ok, 16, 1)
    tattn._check_x("qkv", torch.zeros(2, 512, 3 * 1024,
                                      dtype=torch.bfloat16), 16, 3)
    bad = [
        (ok.float(), 16, "bfloat16"),
        (ok, 8, "head dim"),
        (torch.zeros(2, 513, 1024, dtype=torch.bfloat16), 16, "L <="),
        (ok.transpose(0, 1).contiguous().transpose(0, 1), 16, "contiguous"),
    ]
    for x, h, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tattn._check_x("x", x, h, 1)
    with pytest.raises(ValueError, match="w_qkv"):
        tattn._rows(torch.zeros(1024, 1024), (1024, 3 * 1024),
                    torch.bfloat16, ok.device, "w_qkv")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.fused_qkv_attention(torch.zeros(1, 4, 3 * 64, device="meta"), 1)
    # the [B, H, L, D] kernel: bf16, head dim 32 or 64, L <= 1024
    q = torch.zeros(2, 8, 1024, 32, dtype=torch.bfloat16)
    for bad, msg in ((q.float(), "attn_impl='xla'"),
                     (torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16),
                      "head dim 32 or 64"),
                     (torch.zeros(1, 1, 1025, 64, dtype=torch.bfloat16),
                      "L <= 1024")):
        with pytest.raises(ValueError, match=re.escape(msg)):
            tattn._fwd_kernel(bad, bad, bad, 0.1)
    with pytest.raises(ValueError, match="shape"):
        tattn._fwd_kernel(q, q[:, :4], q, 0.1)
    # kernel 8 takes what kernel 7 takes, and do of q's shape and dtype
    for bad, msg in ((q.float(), "attn_impl='xla'"),
                     (torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16),
                      "head dim 32 or 64"),
                     (torch.zeros(1, 1, 1025, 64, dtype=torch.bfloat16),
                      "L <= 1024")):
        with pytest.raises(ValueError, match=re.escape(msg)):
            tattn._fused_bwd_kernel(bad, bad, bad, bad, 0.1)
    with pytest.raises(ValueError, match="do must be"):
        tattn._fused_bwd_kernel(q, q, q, q.float(), 0.1)
    with pytest.raises(ValueError, match="shape"):
        tattn._fused_bwd_kernel(q, q, q, q[:, :4], 0.1)
    # kernel 9: bf16, head dim 32 or 64, any L
    for bad, msg in ((q.float(), "attn_impl='xla'"),
                     (torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16),
                      "head dim 32 or 64")):
        with pytest.raises(ValueError, match=re.escape(msg)):
            tattn._flash_kernel(bad, bad, bad, 0.1)
    with pytest.raises(ValueError, match="shape"):
        tattn._flash_kernel(q, q[:, :4], q, 0.1)
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        _build.check_no_grad(ok, w, what="the LN kernel")
    with torch.no_grad():
        _build.check_no_grad(ok, w, what="the LN kernel")


def test_ctypes_signatures_match_c_source():
    """Each declared argtypes list has one entry per C parameter, pointers
    as c_void_p (a 32-bit default would cut a pointer)."""
    assert set(_build.SIGNATURES) == {"attention", "attention_fwd",
                                      "fused_attention_bwd",
                                      "mlp_w8", "attention_block",
                                      "mlp_bf16", "delta_attention",
                                      "delta_mlp", "flash_attention"}
    # rows 20-22 of the kernel table: one entry point each (each chains
    # the code pass, its fc1 and fc2, each also an entry point); rows
    # 23-25: each its fc1 and the shared fc2 on wgmma (after
    # delta_attention.cu's code pass); row 15: its code pass, fc1 and fc2 on
    # the same two bodies, and the entry that chains them; row 14: the
    # entry that chains its own code pass with row 15's fc1 and fc2
    assert set(_build.SIGNATURES["delta_mlp"]) == {
        f"uspace_{k}" for k in ("base_mlp_grad", "base_mlp_e", "base_mlp_eg",
                                "base_mlp_codes", "base_fc1_grad",
                                "base_fc1_eg", "base_fc2",
                                "delta_fc1_exact", "delta_fc1_lin",
                                "delta_fc1_g", "delta_fc2", "mlp_int8_fc1",
                                "mlp_int8_fc2", "mlp_int8_codes",
                                "ln_mlp_int8", "mlp_int8")}
    for name, sigs in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in sigs.items():
            m = re.search(rf"int {fn}\(([^)]*)\)", src)
            assert m, fn
            params = [p.strip() for p in m.group(1).split(",")]
            assert len(params) == len(argtypes), fn
            for p, t in zip(params, argtypes):
                want = {"int": _build._I, "float": _build._F}.get(
                    p.split()[0], _build._P)
                assert t is want, (fn, p)
        a, b = _build.library_path(name), _build.library_path(name)
        assert a == b and a.parent == _build.BUILD_DIR
