"""The U-ViT kernels' plain twins at head dim 32, held to the JAX package's.

The U-ViT toys (``uspace_tpu/configs/synthetic_attr_e2e.py``,
``synthetic_cond_e2e.py``, ``synthetic_t2i_e2e.py``: embed 128, 4 heads, L =
17) run at head dim 32, which the JAX kernels take (``fused_qkv_attention``
derives it from the width). Here, at B = 2, C = 128, H = 4 (D = 32) and L =
17 and 65 (65 ends in the backward's 16-row tail chunk), each twin of rows
1-5, 10, 18 and 19 (the routes that run row 1's core), and row 4's backward,
against the JAX kernels run in interpret mode on the CPU, as the other
``tests/test_torch_*.py`` hold them at head dim 16 and 64; rows 6 and 11
(the LN-free int8 route and the W8A8 sub-block, now row 5's pieces) at head
dims 32 and 64 (H = 4 and 2). Also: what the
wrappers' checks take and refuse before any launch, the two pieces of the
redesigned row 17 (fc1, then fc2 without a residual) and the three of the
redesigned row 10 (the bf16-chain LN, row 2, the projection with the bias
rounded to bf16 and the residual), each sequence against the interpreted
TPU kernel, and the wrappers' plumbing of those pieces (and of rows 6 and
11's) with the library calls stubbed. Inputs come from numpy seeds.

Tolerances, as the files of each row hold them: f32 1e-5 (ops) and 1e-4
(the sub-block on its update); bf16 2e-2 for the attention ops (one bf16
rounding of an O(1) value is 8e-3), one bf16 step of the largest output
(rel-L2 5e-3) for the sub-block and the w8 MLP (JAX on the CPU keeps a
bf16 chain in f32 where the kernels round each operation); int8 routes
max-abs 2e-3 / 2e-2 with rel-L2 1e-4 / 5e-3 (row 19: in f32 its delta
part at 5e-3, as a flipped difference code moves it by a step; in bf16 its
output, as the part is about one bf16 step of it), codes one step apart at
most, row scales within 1e-6.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.ops import attention as jattn
from uspace_tpu.ops import delta as jdelta
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu.ops.quant import quantize_colwise as jquantize_colwise
from uspace_tpu_torch.ops import attention as tattn
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops import mlp as tmlp
from uspace_tpu_torch.ops import quant as tquant
from uspace_tpu_torch.ops.quant import quantize_colwise

B, C, H, D = 2, 128, 4, 32
SCALE = D ** -0.5
LENGTHS = [17, 65]
DT = {"f32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
INT8_TOL = {"f32": (2e-3, 1e-4), "bf16": (2e-2, 5e-3)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _close(port, ref, atol, rel=None, base=None):
    """max-abs ``atol`` and, with ``rel``, rel-L2 (of ``x - base`` for both
    when ``base`` is given)."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    err = np.abs(p - r).max()
    assert err <= atol, (err, atol)
    if rel is not None:
        if base is not None:
            p, r = p - _np(base), r - _np(base)
        got = np.linalg.norm(p - r) / np.linalg.norm(r)
        assert got <= rel, (got, rel)


def _step(ref):
    """One bf16 step of the largest |ref|."""
    return 2.0 ** (math.floor(math.log2(np.abs(_np(ref)).max())) - 7)


def _inputs(seed, l):
    r = np.random.default_rng(seed)
    return dict(
        qkv=r.standard_normal((B, l, 3 * C)).astype(np.float32),
        x=r.standard_normal((B, l, C)).astype(np.float32),
        w=(r.standard_normal((C, 3 * C)) * C ** -0.5).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(C)).astype(np.float32),
        b=(0.1 * r.standard_normal(C)).astype(np.float32),
        wp=(r.standard_normal((C, C)) * C ** -0.5).astype(np.float32),
        bp=(0.1 * r.standard_normal(C)).astype(np.float32),
        g=r.standard_normal((B, l, C)).astype(np.float32))


# ---------------------------------------------------------------------------
# rows 1-3: the packed core and the bf16 projection routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_packed_twin_matches_jax(dt, l):
    jd, td, tol = DT[dt]
    a = _inputs(1, l)
    ref = jattn.fused_qkv_attention(jnp.asarray(a["qkv"], jd), H,
                                    interpret=True)
    out = tattn.fused_qkv_attention(_t(a["qkv"], td), H)
    assert out.dtype == td and out.shape == (B, l, C)
    _close(out, ref, tol)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_qkvproj_twin_matches_jax(dt, l):
    jd, td, tol = DT[dt]
    a = _inputs(2, l)
    ref = jattn.fused_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["w"]), H, interpret=True)
    out = tattn.fused_qkvproj_attention(_t(a["x"], td), _t(a["w"]), H)
    assert out.dtype == td
    _close(out, ref, tol)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_ln_qkvproj_twin_matches_jax(dt, l):
    jd, td, tol = DT[dt]
    a = _inputs(3, l)
    ref = jattn.fused_ln_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w"]), H, quant=False, interpret=True)
    with torch.no_grad():
        out = tattn.fused_ln_qkvproj_attention(
            _t(a["x"], td), _t(a["s"]), _t(a["b"]), _t(a["w"]), H)
    _close(out, ref, tol)


# ---------------------------------------------------------------------------
# row 4: the packed backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_packed_vjp_matches_jax(dt, l):
    """Port autograd of fused_qkv_attention (the backward twin) against the
    JAX custom VJP (_packed_bwd_kernel, interpret mode); L = 65 ends in the
    card's 16-row tail chunk."""
    jd, td, tol = DT[dt]
    a = _inputs(4, l)
    qkv0 = 0.5 * a["qkv"]
    out_j, vjp = jax.vjp(
        lambda q: jattn.fused_qkv_attention(q, H, interpret=True),
        jnp.asarray(qkv0, jd))
    (ref,) = vjp(jnp.asarray(a["g"], jd))
    qkv = _t(qkv0, td).requires_grad_()
    out = tattn.fused_qkv_attention(qkv, H)
    out.backward(_t(a["g"], td))
    assert qkv.grad.dtype == td and qkv.grad.shape == qkv.shape
    _close(out.detach(), out_j, tol)
    _close(qkv.grad, ref, tol)
    _close(tattn.packed_attention_bwd(qkv.detach(), _t(a["g"], td), H), ref,
           tol)


# ---------------------------------------------------------------------------
# row 5: the int8 LN + QKV-projection route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_ln_qkvproj_int8_twin_matches_jax(dt, l):
    jd, td, _ = DT[dt]
    atol, rel = INT8_TOL[dt]
    a = _inputs(5, l)
    ref = jattn.fused_ln_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w"]), H, quant=True, interpret=True)
    with torch.no_grad():
        out = tattn.fused_ln_qkvproj_attention(
            _t(a["x"], td), _t(a["s"]), _t(a["b"]), _t(a["w"]), H, quant=True)
    assert out.dtype == td
    _close(out, ref, atol, rel)


# ---------------------------------------------------------------------------
# row 10: the bf16 attention sub-block, and its three pieces
# ---------------------------------------------------------------------------


BLOCK_ARGS = ("x", "s", "b", "w", "wp", "bp")


def _block_refs(dt, l, seed):
    jd, td, _ = DT[dt]
    a = _inputs(seed, l)
    a["x"] = 0.05 * a["x"]  # at the update's scale: the residual keeps it
    ref = jattn.fused_attention_block(
        *(jnp.asarray(a[k], jd if k == "x" else jnp.float32)
          for k in BLOCK_ARGS), H, interpret=True)
    return a, td, ref


def _close_update(dt, out, ref, x):
    if dt == "f32":
        _close(out, ref, 1e-4, 1e-4, x)
    else:
        _close(out, ref, _step(ref), 5e-3, x)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_attention_block_twin_matches_jax(dt, l):
    a, td, ref = _block_refs(dt, l, 6)
    x = _t(a["x"], td)
    with torch.no_grad():
        out = tattn.fused_attention_block(
            x, *(_t(a[k]) for k in BLOCK_ARGS[1:]), H)
    assert out.dtype == td
    _close_update(dt, out, ref, x)


@pytest.mark.parametrize("dt", list(DT))
def test_attention_block_three_pieces_match_jax(dt):
    """Row 10 as the card runs it: the bf16-chain LN1 pass, row 2's twin on
    its rows, then the projection of mlp_bf16.cu's fc2 GEMM, ``x + bf16(
    f32(a @ Wproj) + f32(bf16(b_proj)))`` with the bias as the wrapper
    passes it (rounded to bf16, held in f32), against the interpreted
    _attn_block_kernel; and equal to the one twin bit for bit."""
    a, td, ref = _block_refs(dt, 17, 7)
    x = _t(a["x"], td)
    s, b, w, wp, bp = (_t(a[k]) for k in BLOCK_ARGS[1:])
    xln = tmlp._ln_bf16_normalise(x, s, b, 1e-5).to(td)
    att = tattn.qkvproj_attention_plain(xln, w, H, SCALE)
    bias = bp.to(td).float()  # what _block_kernel hands the GEMM
    out = x + (torch.matmul(att.float(), wp.to(td).float()) + bias).to(td)
    _close_update(dt, out, ref, x)
    twin = tattn.attention_block_plain(x, s, b, w, wp, bp, H, SCALE, 1e-5)
    assert torch.equal(out, twin)


def test_attention_block_wrapper_runs_the_three_pieces(monkeypatch):
    """_block_kernel's plumbing with the library calls stubbed: the LN pass
    (``mlp_w8.cu``'s) and row 2's entry at head dim 32, then
    ``_bf16_fc2_kernel`` on the
    attention rows with Wproj's torch-layout bf16 rows, the bias rounded to
    bf16 and held in f32, and x as the residual; one launch counted."""
    calls = {}

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls[fn] = args
                return 0
            return call

    def fc2(h, w2, b2, res=None):
        calls["fc2"] = (h, w2, b2, res)
        return torch.zeros_like(res)

    monkeypatch.setattr(tattn, "load", lambda name: Lib())
    monkeypatch.setattr(tattn, "cuda_stream", lambda dev: None)
    monkeypatch.setattr(tattn, "_bf16_fc2_kernel", fc2)
    monkeypatch.setattr(tattn, "_w8_ln_kernel", lambda x2d, *a: calls.setdefault(
        "ln", torch.zeros_like(x2d)))
    a = _inputs(8, 17)
    x = _t(a["x"], torch.bfloat16)
    s, b, w, wp, bp = (_t(a[k]) for k in BLOCK_ARGS[1:])
    tattn.reset_launches()
    out = tattn._block_kernel(x, s, b, w, wp, bp, H, SCALE, 1e-5)
    assert out.shape == x.shape and tattn.LAUNCHES["attention_block"] == 1
    assert set(calls) == {"ln", "uspace_qkvproj_attention", "fc2"}
    assert calls["uspace_qkvproj_attention"][4:8] == (B, 17, H, D)
    h, w2, b2, res = calls["fc2"]
    assert h.shape == (B * 17, C) and res.data_ptr() == x.data_ptr()
    assert torch.equal(w2, wp.to(torch.bfloat16).t().contiguous())
    assert b2.dtype == torch.float32
    assert torch.equal(b2, bp.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# rows 6 and 11: the LN-free int8 route and the W8A8 sub-block, on row 5's
# pieces at head dims 32 and 64
# ---------------------------------------------------------------------------


def _tpu_rounding_block_q_kernel():
    """``_attn_block_kernel_q`` with its two bf16 -> f32 widenings (the LN1
    rows and the attention rows, each coded to int8) kept as bf16 values, as
    a TPU holds them; XLA on the CPU may elide the round trip. Made from the
    reference's own source (``tests/test_torch_block.py`` patches it the
    same way); the JAX package is not changed."""
    src = inspect.getsource(jattn._attn_block_kernel_q)
    keep = ("jax.lax.reduce_precision({}.astype(jnp.float32), "
            "exponent_bits=8, mantissa_bits=7)")
    new = src.replace("xln.astype(jnp.float32)", keep.format("xln"))
    new = new.replace("qkv_buf[:, 0:c].astype(jnp.float32)",
                      keep.format("qkv_buf[:, 0:c]"))
    assert new.count("reduce_precision") == 2
    ns = dict(vars(jattn))
    exec(new, ns)
    return ns["_attn_block_kernel_q"]


@pytest.mark.parametrize("h", [H, 2])  # head dims 32 and 64 at C = 128
@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_qkvproj_int8_twin_matches_jax(dt, l, h):
    """Row 6 (the bf16 rows coded as they are, the int8 projection, the
    core) against the interpreted _qkv_attn_kernel_q."""
    jd, td, _ = DT[dt]
    atol, rel = INT8_TOL[dt]
    a = _inputs(10, l)
    ref = jattn.fused_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["w"]), h, quant=True,
        interpret=True)
    with torch.no_grad():
        out = tattn.fused_qkvproj_attention(_t(a["x"], td), _t(a["w"]), h,
                                            quant=True)
    assert out.dtype == td and out.shape == (B, l, C)
    _close(out, ref, atol, rel)


@pytest.mark.parametrize("h", [H, 2])
@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_attention_block_q_twin_matches_jax(dt, l, h, monkeypatch):
    """Row 11 on its update out - x against the interpreted
    _attn_block_kernel_q (bf16: with its bf16 values kept bf16 on the CPU,
    as tests/test_torch_block.py holds it at head dim 16). The update is
    proj of the attention rows' int8 codes, as row 19's part is of da's:
    in f32 an attention sum taken in another order flips one code by one
    step now and then (one row of 34 here), which moves that row's update by
    a code step, so f32 takes row 19's rel-L2 5e-3 on the part."""
    jd, td, _ = DT[dt]
    atol, rel = INT8_TOL[dt]
    if dt == "bf16":
        monkeypatch.setattr(jattn, "_attn_block_kernel_q",
                            _tpu_rounding_block_q_kernel())
    a = _inputs(11, l)
    a["x"] = 0.05 * a["x"]  # at the update's scale: the residual keeps it
    ref = jattn.fused_attention_block_q(
        *(jnp.asarray(a[k], jd if k == "x" else jnp.float32)
          for k in BLOCK_ARGS), h, interpret=True)
    x = _t(a["x"], td)
    with torch.no_grad():
        out = tattn.fused_attention_block_q(
            x, *(_t(a[k]) for k in BLOCK_ARGS[1:]), h)
    assert out.dtype == td
    _close(out, ref, atol, 5e-3 if dt == "f32" else rel, base=x)


def test_int8_routes_run_row_5s_pieces(monkeypatch):
    """Rows 6 and 11's plumbing at head dim 32 with the library calls
    stubbed: row 6 is attention_block.cu's code pass on x, the int8 GEMM of
    all heads into a [B, L, 3C] workspace and the core, one launch counted;
    row 11 is the LN pass, those three pieces on its rows, the code pass on
    the attention rows and the int8 projection with the residual, one launch
    counted."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, args))
                return 0
            return call

    monkeypatch.setattr(tattn, "load", lambda name: Lib())
    monkeypatch.setattr(tattn, "cuda_stream", lambda dev: None)
    monkeypatch.setattr(tattn, "_w8_ln_kernel",
                        lambda x2d, *a: torch.zeros_like(x2d))
    a = _inputs(12, 17)
    x = _t(a["x"], torch.bfloat16)
    qw = tquant.quantized_weight(_t(a["w"]))
    pieces = ["uspace_row_codes", "uspace_qkv_gemm_int8",
              "uspace_packed_attention"]
    tattn.reset_launches()
    out = tattn._int8_kernel(x, qw, H, SCALE)
    assert out.shape == x.shape
    assert [fn for fn, _ in calls] == pieces
    rows = B * 17
    assert calls[0][1][3:5] == (rows, C)
    assert calls[1][1][5:8] == (rows, 3 * C, C)
    assert calls[2][1][2:6] == (B, 17, H, D)
    assert tattn.LAUNCHES["qkvproj_attention_int8"] == 1
    assert sum(tattn.LAUNCHES.values()) == 1
    calls.clear()
    s, b, w, wp, bp = (_t(a[k]) for k in BLOCK_ARGS[1:])
    tattn._block_kernel(x, s, b, w, wp, bp, H, SCALE, 1e-5,
                        (qw, tquant.quantized_weight(wp)))
    assert [fn for fn, _ in calls] == pieces + [
        "uspace_row_codes", "uspace_proj_residual_int8"]
    assert calls[2][1][2:6] == (B, 17, H, D)
    assert tattn.LAUNCHES["attention_block_int8"] == 1
    assert sum(tattn.LAUNCHES.values()) == 2


# ---------------------------------------------------------------------------
# rows 18 and 19: the stage-delta attention halves on row 1's core
# ---------------------------------------------------------------------------


def _weights(r, k, n, std):
    w = (r.standard_normal((k, n)) * std).astype(np.float32)
    jq, js = jquantize_colwise(jnp.asarray(w))
    tq, ts = quantize_colwise(torch.from_numpy(w))
    assert (np.asarray(jq) == tq.numpy()).all()
    return (jq, js), (tq, ts)


def _codes(port, ref):
    d = np.abs(_np(port) - _np(ref))
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dt", list(DT))
def test_delta_attention_twins_match_jax(dt, l):
    """Row 18 (base: output, codes and scales of its cache) and row 19 (the
    delta on JAX's own cache, on what it adds, xm - xm_b) at head dim 32."""
    jd, td, _ = DT[dt]
    atol, rel = INT8_TOL[dt]
    r = np.random.default_rng(9 + l)
    xb = r.standard_normal((B, l, C)).astype(np.float32)
    x = xb + 1e-2 * r.standard_normal(xb.shape).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(C)).astype(np.float32)
    b = (0.1 * r.standard_normal(C)).astype(np.float32)
    (jq, js), (tq, ts) = _weights(r, C, 3 * C, C ** -0.5)
    (jp, jsp), (tp, tsp) = _weights(r, C, C, C ** -0.5)
    xmb = r.standard_normal((B, l, C)).astype(np.float32)

    def both(v):
        return jnp.asarray(v).astype(jd), torch.from_numpy(v).to(td)

    (jxb, txb), (jx, tx), (jxmb, txmb) = both(xb), both(x), both(xmb)
    ja, jqq, jqs = jdelta.base_attn_block(jxb, jnp.asarray(s), jnp.asarray(b),
                                          jq, js, H, 1e-5, interpret=True)
    with torch.no_grad():
        ta, tqq, tqs = tdelta.base_attn_block(txb, _t(s), _t(b), tq, ts, H,
                                              1e-5)
    _close(ta, ja, atol, rel)
    _codes(tqq[:, :l], jqq[:, :l])
    _close(tqs[:, :l], jqs[:, :l], 1e-6)

    def torch_of(v):
        return torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)

    jxm = jdelta.delta_attn_block(jx, jxb, jqq, jqs, ja, jxmb, jnp.asarray(s),
                                  jnp.asarray(b), jq, js, jp, jsp, H, 1e-5,
                                  interpret=True)
    with torch.no_grad():
        txm = tdelta.delta_attn_block(
            tx, txb, torch.from_numpy(np.array(jqq)),
            torch.from_numpy(np.array(jqs)), torch_of(ja), txmb, _t(s), _t(b),
            tq, ts, tp, tsp, H, 1e-5)
    # f32: on its part xm - xm_b at rel-L2 5e-3: an f32 sum taken in another
    # order flips a code of da = a - a_b by one step, which moves the part by
    # a step of that row's scale (1e-3 at this width over seeds, up to 3e-3
    # with larger weights; the card holds row 19 to 2.5e-3 against its plain
    # twin, PERF.md section 2). bf16: the part of a stage 1e-2 away is
    # about one bf16 step of the O(1) output, where JAX on the CPU and the
    # twin round apart (one step at 2-20% of the rows at C = 64 and 128),
    # so the output itself at the int8 bf16 rule
    if dt == "f32":
        _close(txm, jxm, atol, 5e-3, base=txmb)
    else:
        _close(txm, jxm, atol, rel)


# ---------------------------------------------------------------------------
# what the wrappers take and refuse before any launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,ok", [(32, True), (64, True), (16, False),
                                  (128, False)])
@pytest.mark.parametrize("parts", [1, 3])
def test_check_x_takes_head_dims_32_and_64(d, ok, parts):
    x = torch.zeros(B, 17, parts * 2 * d, dtype=torch.bfloat16)
    if ok:
        assert tattn._check_x("x", x, 2, parts) == d
        return
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        tattn._check_x("x", x, 2, parts)


def test_projection_routes_refuse_c_not_a_multiple_of_64():
    """At head dim 32 an odd head count gives C = 32 mod 64, which the
    projection's 64-deep K chunks cannot take: refused before any launch."""
    with pytest.raises(ValueError, match="multiple of 64"):
        tattn._check_x("x", torch.zeros(B, 17, 3 * 32, dtype=torch.bfloat16),
                       3, 1)
    # the packed core alone takes it
    assert tattn._check_x("qkv", torch.zeros(B, 17, 9 * 32,
                                             dtype=torch.bfloat16), 3, 3) == 32


def test_stage_delta_operands_take_head_dim_32():
    x = torch.zeros(B, 17, C, dtype=torch.bfloat16)
    one = torch.ones(C)
    lns, _, _ = tdelta._attn_operands(x, H, C, one, one, torch.ones(3 * C),
                                      x.device)
    assert lns.shape == (C,)
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        tdelta._attn_operands(x, 8, C, one, one, torch.ones(3 * C), x.device)


# ---------------------------------------------------------------------------
# row 17: the two GEMMs of the w8 MLP
# ---------------------------------------------------------------------------


def _w8_inputs(seed, c=C, hidden=4 * C, out=C):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((B, 17, c)).astype(np.float32),
        w1=(r.standard_normal((c, hidden)) * 0.1).astype(np.float32),
        b1=(r.standard_normal(hidden) * 0.02).astype(np.float32),
        w2=(r.standard_normal((hidden, out)) * 0.05).astype(np.float32),
        b2=(r.standard_normal(out) * 0.02).astype(np.float32))


@pytest.mark.parametrize("dt", list(DT))
def test_mlp_w8_two_pieces_match_jax(dt):
    """Row 17 as the card runs it: fc1 on x, ``h = bf16(gelu(f32(x . q1^T)
    * s1 + b1))`` over the whole hidden width, then fc2 without a residual,
    ``bf16(f32(h . q2^T) * s2 + b2)``, against the interpreted
    _mlp_kernel_w8 (through ``fused_mlp(quant="w8")``) and the twin."""
    jd, td, _ = DT[dt]
    a = _w8_inputs(10)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp(jnp.asarray(a["x"], jd), *map(jnp.asarray, ws),
                         quant="w8", interpret=True)
    x = _t(a["x"], td).reshape(-1, C)
    q1, q2 = tquant.quantized_weight(_t(a["w1"])), tquant.quantized_weight(
        _t(a["w2"]))
    b1, b2 = _t(a["b1"]), _t(a["b2"])
    h = tmlp._gelu_f32(torch.matmul(x.float(), q1.q.float().t()) * q1.scale
                       + b1).to(td)
    out = (torch.matmul(h.float(), q2.q.float().t()) * q2.scale
           + b2).to(td).reshape(a["x"].shape)
    assert out.dtype == td
    if dt == "f32":
        _close(out, ref, 1e-5)
    else:
        _close(out, ref, _step(ref), 5e-3)
    twin = tmlp.mlp_w8_plain(x, q1, b1, q2, b2, tmlp.col_slices(4 * C))
    _close(out.reshape(twin.shape), twin, 1e-5 if dt == "f32" else _step(
        twin))


def test_mlp_w8_wrapper_passes_its_workspace(monkeypatch):
    """_mlp_w8_kernel with the library call stubbed: row 17's entry takes x,
    the weights, an [R, hidden] bf16 workspace for h and the output; one
    launch counted."""
    calls = {}

    class Lib:
        def uspace_mlp_w8(self, *args):
            calls["args"] = args
            return 0

    monkeypatch.setattr(tmlp, "load", lambda name: Lib())
    monkeypatch.setattr(tmlp, "cuda_stream", lambda dev: None)
    a = _w8_inputs(11, c=1536, hidden=512, out=1280)
    x = _t(a["x"], torch.bfloat16).reshape(-1, 1536)
    q1, q2 = (tquant.quantized_weight(_t(a[k])) for k in ("w1", "w2"))
    tmlp.reset_launches()
    out = tmlp._mlp_w8_kernel(x, q1, _t(a["b1"]), q2, _t(a["b2"]))
    assert out.shape == (B * 17, 1280) and tmlp.LAUNCHES["mlp_w8"] == 1
    assert len(calls["args"]) == 14
    assert calls["args"][9:13] == (B * 17, 1536, 512, 1280)


@pytest.mark.parametrize("c,hidden,out,ok", [
    (1024, 4096, 1024, True), (1536, 6144, 1280, True), (64, 128, 128, True),
    (96, 384, 128, False), (128, 192, 128, False), (128, 512, 200, False)])
def test_mlp_w8_range_is_what_the_gemms_need(monkeypatch, c, hidden, out, ok):
    """C a multiple of 64, hidden and output widths multiples of 128: every
    shape the old block took stays taken (C = 1024, out = 1024), and one it
    refused (C = 1536, out = 1280) is now taken."""
    monkeypatch.setattr(tmlp, "load", lambda name: type(
        "Lib", (), {"uspace_mlp_w8": lambda self, *a: 0})())
    monkeypatch.setattr(tmlp, "cuda_stream", lambda dev: None)
    x = torch.zeros(3, c, dtype=torch.bfloat16)
    q1 = tquant.quantized_weight(torch.ones(c, hidden))
    q2 = tquant.quantized_weight(torch.ones(hidden, out))
    args = (x, q1, torch.zeros(hidden), q2, torch.zeros(out))
    if ok:
        assert tmlp._mlp_w8_kernel(*args).shape == (3, out)
        return
    with pytest.raises(ValueError, match="multiple"):
        tmlp._mlp_w8_kernel(*args)
