"""The pieces that the card runs for the W8A8 MLP sub-block (row 15 of the
kernel table), for the stage-delta attention halves (rows 18 and 19) and
for the stage-delta base MLP halves (rows 20, 21 and 22), through their
twins, held to the JAX kernels on the CPU.

Row 18 runs as the padded LN1 code pass, the int8 GEMM twice (pass A: each
row's max |qkv| over each 256-column tile; pass B: the same product coded
per row with the max of those partials) and row 1's core; its piece twins
in sequence are ``base_attn_plain``, which
``test_torch_delta.test_base_attn_twin_matches_jax`` holds to the JAX
kernel, and here they equal the one-pass coding of the whole row bit for
bit. Row 20 runs row 21's pieces, its affine codes kept in the workspace.

Row 15 runs as a code pass (the bf16-chain LN2 rows coded per row), fc1
(GELU on an affine grid per row and strip) and fc2 (the strips folded in
order, the residual in x's dtype); row 19 as the code pass of LN1(x) -
LN1(x_b), the qkv GEMM with the cache epilogue, the attention core, the
codes of a - a_b and the xm GEMM with the stream epilogue. The whole twins
(``ln_mlp_int8_plain``, ``delta_attn_plain``) are these pieces' twins in
sequence; here the pieces, called one by one, hold the JAX kernel run in
interpret mode at the int8 tolerances of the whole twins' own tests
(``test_torch_quant.test_mlp_block_int8_twin_matches_jax``,
``test_torch_delta.test_delta_attn_twin_matches_jax``): row 15 on its
output, with max-abs one bf16 step of the largest output where that
exceeds 2e-2 in bf16; row 19 in f32 on its part xm - xm_b at the rel-L2
5e-3 that ``test_torch_headdim32`` states for that part, in bf16 on xm (see
the test). The wrappers' plumbing on the card runs with the library calls
stubbed: the pieces in order on the workspaces between them, one launch
counted, every refusal before any call.

Rows 21 and 22 run as the f32 code pass of LN2(x), the mode's fc1 (row 22:
GELU(e) on the affine grid and gelu'(e) coded per row and strip; row 21: e
coded per row and strip, GELU of the coded e on the affine grid) and fc2
storing m beside x + m. Their piece twins in sequence are the whole twins
(``base_mlp_grad_plain``, ``base_mlp_e_plain(emit_gelu=True)``). Each
piece holds float64 arithmetic of what it computes at 1 to 4 strips, and
the whole twins hold the interpreted ``base_mlp_block`` at the tolerances
of their own tests
(``test_torch_delta.test_base_mlp_twin_matches_jax``,
``test_torch_delta_modes.test_base_mlp_e_twin_matches_jax``). Inputs come
from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.ops import delta as jdelta
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu.ops.quant import quantize_colwise as jquantize_colwise
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops import mlp as tmlp
from uspace_tpu_torch.ops import quant as tquant

# (JAX dtype, torch dtype, max-abs, rel-L2): the int8 tolerances of the
# whole twins' tests
DT = {"f32": (jnp.float32, torch.float32, 2e-3, 1e-4),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 5e-3)}
EPS = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _close(port, ref, atol, rel, base=None):
    """max-abs, and rel-L2 of ``x - base``."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    err = np.abs(p - r).max()
    assert err <= atol, (err, atol)
    if base is not None:
        p, r = p - _np(base), r - _np(base)
    got = np.linalg.norm(p - r) / np.linalg.norm(r)
    assert got <= rel, (got, rel)


def _to_torch(a):
    """A JAX array as the torch tensor of the same dtype (bf16 exactly)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _stub(monkeypatch, module):
    """Record the library calls of ``module``'s wrappers; each returns 0."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, args))
                return 0
            return call

    monkeypatch.setattr(module, "load", lambda name: Lib())
    monkeypatch.setattr(module, "cuda_stream", lambda dev: None)
    return calls


# ---------------------------------------------------------------------------
# row 15: the W8A8 MLP sub-block
# ---------------------------------------------------------------------------


def _mlp_case(seed, c, dt):
    """x [2, 17, C], LN2, w1 [C, 4C], w2 [4C, C] (JAX layout) and biases;
    4 strips of C."""
    r = np.random.default_rng(seed)
    hid = 4 * c
    a = dict(x=r.standard_normal((2, 17, c)).astype(np.float32),
             s=(1 + 0.1 * r.standard_normal(c)).astype(np.float32),
             b=(0.1 * r.standard_normal(c)).astype(np.float32),
             w1=(r.standard_normal((c, hid)) * c ** -0.5).astype(np.float32),
             b1=(r.standard_normal(hid) * 0.02).astype(np.float32),
             w2=(r.standard_normal((hid, c)) * 0.5 * hid ** -0.5).astype(
                 np.float32),
             b2=(r.standard_normal(c) * 0.02).astype(np.float32))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["x"] = t["x"].to(DT[dt][1])
    return a, t


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("dt", list(DT))
def test_int8_mlp_pieces_compose_to_the_twin(dt, c):
    """The code pass, fc1 and fc2 twins in sequence (what
    ``ln_mlp_int8_plain`` runs) hold the interpreted
    ``_mlp_kernel_int8_lnres``."""
    jd, td, atol, rel = DT[dt]
    a, t = _mlp_case(15 + c, c, dt)
    x2d = t["x"].reshape(-1, c)
    q1, q2 = tquant.quantized_weight(t["w1"]), tquant.quantized_weight(t["w2"])
    strips = tmlp.col_slices(4 * c)
    assert strips == 4
    xq, xs = tquant.row_codes(tmlp._ln_bf16_normalise(x2d, t["s"], t["b"],
                                                      EPS))
    hq, scale, zp = tmlp.mlp_int8_fc1_plain(xq, xs, q1, t["b1"], strips)
    assert hq.dtype == torch.int8 and hq.shape == (34, 4 * c)
    assert scale.shape == zp.shape == (34, strips)
    out = tmlp.mlp_int8_fc2_plain(hq, scale, zp, q2, t["b2"], x2d)
    assert out.dtype == td and out.shape == x2d.shape
    ref = jmlp.fused_mlp_block_q(
        jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        *(jnp.asarray(a[k]) for k in ("w1", "b1", "w2", "b2")),
        interpret=True)
    if dt == "bf16":
        # the residual add rounds at x's magnitude: one bf16 step of the
        # largest output, 2**-5 past |x| = 4, where the 2e-2 of the whole
        # twin's test assumes outputs of O(1-4)
        top = float(np.abs(_np(ref)).max())
        atol = max(atol, 2.0 ** (np.floor(np.log2(top)) - 7))
    _close(out.reshape(a["x"].shape), ref, atol, rel)


def test_int8_mlp_block_runs_its_pieces(monkeypatch):
    """Row 15's plumbing on the card, the library stubbed: one call of the
    C entry that chains the code pass, fc1 and fc2, with x, LN2, both
    weights, the colsums and the output, and five workspaces (the [R,
    hidden] int8 hidden, the [R, C] int8 row codes, the [R] f32 row scales,
    the [R, strips] f32 scales and zero points) in one allocation; one
    launch counted."""
    calls = _stub(monkeypatch, tmlp)
    r, c, hid, strips = 10, 256, 1024, 4
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((r, c)).astype(
        np.float32)).to(torch.bfloat16)
    q1 = tquant.quantized_weight(torch.from_numpy(
        rng.standard_normal((c, hid)).astype(np.float32)))
    q2 = tquant.quantized_weight(torch.from_numpy(
        rng.standard_normal((hid, c)).astype(np.float32)))
    one, b1 = torch.ones(c), torch.zeros(hid)
    tmlp.reset_launches()
    o = tmlp._ln_mlp_int8_kernel(x, (one, one, EPS), q1, b1, q2, one,
                                 strips)
    assert o.shape == x.shape and o.dtype == torch.bfloat16
    assert [fn for fn, _ in calls] == ["uspace_ln_mlp_int8"]
    (_, args), = calls
    assert args[0] == x.data_ptr()
    assert args[3:5] == (q1.q.data_ptr(), q1.scale.data_ptr())
    assert args[6:8] == (q2.q.data_ptr(), q2.scale.data_ptr())
    assert args[9] == q2.colsums(strips).data_ptr()
    hq, codes, sr, hsc, hzp = args[12], args[10], args[11], args[13], args[14]
    # in one allocation (the card's allocator aligns it to 512 bytes), in
    # this order, each 256-byte aligned past the one before it
    assert all((p - hq) % 256 == 0 for p in (codes, sr, hsc, hzp))
    assert codes - hq >= r * hid and sr - codes >= r * c
    assert hsc - sr >= 4 * r and hzp - hsc >= 4 * r * strips
    assert args[15] == o.data_ptr()
    assert args[16:21] == (r, c, hid, strips, EPS)
    assert tmlp.LAUNCHES["ln_mlp_int8"] == 1
    assert sum(tmlp.LAUNCHES.values()) == 1
    # refused before any call: a strip of 128, an f32 x
    del calls[:]
    with pytest.raises(ValueError, match="strip width"):
        tmlp._ln_mlp_int8_kernel(x, (one, one, EPS), q1, b1, q2, one, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        tmlp._ln_mlp_int8_kernel(x.float(), (one, one, EPS), q1, b1, q2,
                                 one, strips)
    assert calls == [] and tmlp.LAUNCHES["ln_mlp_int8"] == 1


# ---------------------------------------------------------------------------
# row 19: the stage-delta attention half
# ---------------------------------------------------------------------------


def _weights(r, k, n, std):
    w = (r.standard_normal((k, n)) * std).astype(np.float32)
    jq, js = jquantize_colwise(jnp.asarray(w))
    tq, ts = tquant.quantize_colwise(torch.from_numpy(w))
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("l", [17, 65])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_delta_attn_pieces_compose_to_the_twin(dt, l):
    """B = 2, C = 128 in 2 heads, on the JAX base's padded cache: the code
    pass, qkv GEMM, core, difference codes and xm GEMM twins in sequence
    (what ``delta_attn_plain`` runs) hold the interpreted
    ``_delta_attn_kernel``."""
    jd, td, atol, rel = DT[dt]
    b, c, h = 2, 128, 2
    r = np.random.default_rng(19 + l)
    xb = r.standard_normal((b, l, c)).astype(np.float32)
    x = xb + 1e-2 * r.standard_normal(xb.shape).astype(np.float32)
    xmb = r.standard_normal((b, l, c)).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    bb = (0.1 * r.standard_normal(c)).astype(np.float32)
    (jq, js), (tq, ts) = _weights(r, c, 3 * c, 0.2)
    (jp, jsp), (tp, tsp) = _weights(r, c, c, 0.1)
    jx, jxb, jxmb = (jnp.asarray(v).astype(jd) for v in (x, xb, xmb))
    tx, txb, txmb = (torch.from_numpy(v).to(td) for v in (x, xb, xmb))
    ts_, tb_ = torch.from_numpy(s), torch.from_numpy(bb)
    ja, jqq, jqs = jdelta.base_attn_block(jxb, jnp.asarray(s),
                                          jnp.asarray(bb), jq, js, h, EPS,
                                          interpret=True)
    a_b, qq, qs = _to_torch(ja), _to_torch(jqq), _to_torch(jqs)
    lp = tdelta.round_up(l, tdelta.SEQ_ALIGN)
    assert qq.shape == (b, lp, 3 * c)
    codes, ds = tdelta.ln_delta_codes_plain(tx, txb, ts_, tb_, EPS)
    qkv = tdelta.qkv_delta_plain(codes.reshape(-1, c), ds.reshape(-1, 1), tq,
                                 ts, qq, qs, l, td)
    assert qkv.shape == (b * l, 3 * c) and qkv.dtype == td
    a = tdelta.packed_attention_plain(qkv.reshape(b, l, 3 * c), h,
                                      (c // h) ** -0.5)
    dq, das = tquant.row_codes(a.float() - a_b.float())
    xm = tdelta.xm_delta_plain(dq, das, tp, tsp, tx, txb, txmb)
    assert xm.dtype == td and xm.shape == tx.shape
    jxm = jdelta.delta_attn_block(jx, jxb, jqq, jqs, ja, jxmb,
                                  jnp.asarray(s), jnp.asarray(bb), jq, js, jp,
                                  jsp, h, EPS, interpret=True)
    # f32: the part xm - xm_b at rel-L2 5e-3, test_torch_headdim32's rule
    # for row 19's coded part (it reads 0.8-1.8e-3 here: one-step flips of
    # da's row codes where the two attention cores sum in another order);
    # the 1e-4 of the delta twins' JAX tests holds at their toy shape only.
    # bf16: xm itself, as the part is about one bf16 step of it (the part
    # reads 1.1-1.5e-2)
    if dt == "f32":
        _close(xm, jxm, atol, 5e-3, base=txmb)
    else:
        _close(xm, jxm, atol, rel)


def test_delta_attn_block_runs_its_pieces(monkeypatch):
    """Row 19's plumbing on the card, the library stubbed: the code pass of
    x and x_b, the qkv GEMM of those codes on the padded cache (M = B L
    rows, L, Lp), row 1's core on its output, the codes of a - a_b into
    the same workspace, the xm GEMM of them with x, x_b, xm_b; one launch
    counted."""
    calls = _stub(monkeypatch, tdelta)
    b, l, c, h = 2, 17, 128, 2
    lp = tdelta.round_up(l, tdelta.SEQ_ALIGN)
    rng = np.random.default_rng(7)
    x, xb, ab, xmb = (torch.from_numpy(rng.standard_normal((b, l, c)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    (_, _), (tq, ts) = _weights(rng, c, 3 * c, 0.2)
    (_, _), (tp, tsp) = _weights(rng, c, c, 0.1)
    qq = torch.zeros((b, lp, 3 * c), dtype=torch.int8)
    qs = torch.ones((b, lp, 1))
    one = torch.ones(c)
    tdelta.reset_launches()
    xm = tdelta._delta_attn_kernel(x, xb, qq, qs, ab, xmb, one, one, tq, ts,
                                   tp, tsp, h, EPS)
    assert xm.shape == x.shape
    assert [fn for fn, _ in calls] == [
        "uspace_ln_delta_codes", "uspace_qkv_delta",
        "uspace_packed_attention", "uspace_diff_codes", "uspace_xm_delta"]
    codes, qkv, core, diff, xmd = (args for _, args in calls)
    assert codes[:2] == (x.data_ptr(), xb.data_ptr()) and codes[6:8] == (
        b * l, c)
    assert qkv[:2] == codes[4:6]
    assert qkv[4:6] == (qq.data_ptr(), qs.data_ptr())
    assert qkv[7:12] == (b * l, l, lp, 3 * c, c)
    assert core[0] == qkv[6] and core[2:6] == (b, l, h, c // h)
    assert diff[:2] == (core[1], ab.data_ptr()) and diff[2:4] == codes[4:6]
    assert xmd[:2] == codes[4:6]
    assert xmd[4:8] == (x.data_ptr(), xb.data_ptr(), xmb.data_ptr(),
                        xm.data_ptr())
    assert xmd[8:11] == (b * l, c, c)
    assert tdelta.LAUNCHES["delta_attn"] == 1
    assert sum(tdelta.LAUNCHES.values()) == 1
    with pytest.raises(ValueError, match="batch elements"):
        tdelta._qkv_delta_kernel(torch.zeros((3 * l, c), dtype=torch.int8),
                                 torch.ones(3 * l), tq.t(), ts, qq, qs, l)


# ---------------------------------------------------------------------------
# row 18: the stage-delta base attention half, its qkv in two GEMM passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,h,l", [(128, 2, 17), (256, 4, 40)])
@pytest.mark.parametrize("dt", list(DT))
def test_base_attn_pieces_chain_to_the_twin(dt, c, h, l):
    """B = 2 (Lp = round_up(L, 32)), 3C = 384 or 768 columns in 2 or 3
    blocks of 256: the padded code pass, pass A's row amax partials and
    pass B's codes chained equal the qkv coded per row over all 3C columns
    in one pass (``row_codes`` of the product, the TPU kernel's rule) bit
    for bit, and ``base_attn_plain`` is that chain. Control: pass B given
    the amax of one 256-column block instead of the whole row's codes
    otherwise."""
    td = DT[dt][1]
    b = 2
    r = np.random.default_rng(18 + c + l)
    x = torch.from_numpy(r.standard_normal((b, l, c)).astype(
        np.float32)).to(td)
    s = torch.from_numpy((1 + 0.1 * r.standard_normal(c)).astype(np.float32))
    bb = torch.from_numpy((0.1 * r.standard_normal(c)).astype(np.float32))
    _, (tq, ts) = _weights(r, c, 3 * c, 0.2)
    lp = tdelta.round_up(l, tdelta.SEQ_ALIGN)
    u = tdelta.ln_lanes(torch.nn.functional.pad(x, (0, 0, 0, lp - l)), s, bb,
                        EPS)
    uq, us = tquant.row_codes(u.reshape(b * lp, c))
    p = tquant.int_matmul(uq, tq).float() * us * ts
    part = tdelta.qkv_amax_plain(uq, us, tq, ts)
    assert part.shape == (b * lp, -(-3 * c // tdelta.QKV_BLOCK))
    for j in range(part.shape[1]):
        cols = slice(j * tdelta.QKV_BLOCK, (j + 1) * tdelta.QKV_BLOCK)
        assert torch.equal(part[:, j], p[:, cols].abs().amax(dim=1))
    cq, cs, qkv = tdelta.qkv_code_plain(uq, us, tq, ts, part, l, lp, td)
    want_q, want_s = tquant.row_codes(p)
    assert torch.equal(cq, want_q) and torch.equal(cs, want_s)
    real = cq.reshape(b, lp, -1)[:, :l].reshape(b * l, -1)
    assert torch.equal(qkv, (real.float() * cs.reshape(b, lp, 1)[:, :l]
                             .reshape(-1, 1)).to(td))
    a, qq, qs = tdelta.base_attn_plain(x, s, bb, tq, ts, h, EPS)
    assert torch.equal(qq, cq.reshape(b, lp, -1))
    assert torch.equal(qs, cs.reshape(b, lp, 1))
    assert torch.equal(a, tdelta.packed_attention_plain(
        qkv.reshape(b, l, -1), h, (c // h) ** -0.5))
    # the control: amax over the first 256 columns alone
    bad_q, bad_s, _ = tdelta.qkv_code_plain(uq, us, tq, ts, part[:, :1], l,
                                            lp, td)
    assert not torch.equal(bad_s, want_s)
    assert not torch.equal(bad_q, want_q)


def test_base_attn_block_runs_its_pieces(monkeypatch):
    """Row 18's plumbing on the card, the library stubbed: the padded code
    pass of x into the workspace's codes and scales, then one C entry (pass
    A, pass B, row 1's core) on them with the weight, the amax partials,
    the cache, the core's bf16 input (the workspace's last piece) and a,
    through one workspace allocation laid out as ``base_attn_ws_sizes``
    says; one launch counted; a refusal before any call."""
    calls = _stub(monkeypatch, tdelta)
    made = []
    real = tdelta._base_workspace

    def workspace(dev, sizes):
        made.append((list(sizes), real(dev, sizes)))
        return made[-1][1]
    monkeypatch.setattr(tdelta, "_base_workspace", workspace)
    b, l, c, h = 2, 17, 128, 2
    lp = tdelta.round_up(l, tdelta.SEQ_ALIGN)
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((b, l, c)).astype(
        np.float32)).to(torch.bfloat16)
    _, (tq, ts) = _weights(rng, c, 3 * c, 0.2)
    one = torch.ones(c)
    tdelta.reset_launches()
    a, qq, qs = tdelta._base_attn_kernel(x, one, one, tq, ts, h, EPS)
    assert a.shape == x.shape and qq.shape == (b, lp, 3 * c)
    assert qs.shape == (b, lp, 1) and qq.dtype == torch.int8
    assert [fn for fn, _ in calls] == ["uspace_ln_codes", "uspace_base_attn"]
    (_, codes), (_, core) = calls
    (sizes, ws), = made
    assert sizes == tdelta.base_attn_ws_sizes(b, l, lp, c) == [
        b * lp * c, 4 * b * lp, 4 * b * lp * 2, 2 * b * l * 3 * c]
    assert ws.dtype == torch.uint8
    assert ws.numel() == sum(-(-n // 256) * 256 for n in sizes)
    at = [ws.data_ptr()]
    for n in sizes[:-1]:
        at.append(at[-1] + -(-n // 256) * 256)
    assert codes[0] == x.data_ptr() and codes[3:5] == tuple(at[:2])
    assert codes[5:10] == (b, l, lp, c, EPS)
    assert core[:2] == tuple(at[:2]) and core[4] == at[2]
    assert core[5:9] == (qq.data_ptr(), qs.data_ptr(), at[3], a.data_ptr())
    assert core[9:14] == (b, l, lp, h, c // h)
    assert core[14] == (c // h) ** -0.5 and len(core) == 16
    assert tdelta.LAUNCHES["base_attn_cache"] == 1
    assert sum(tdelta.LAUNCHES.values()) == 1
    del calls[:]
    with pytest.raises(ValueError, match="bfloat16"):
        tdelta._base_attn_kernel(x.float(), one, one, tq, ts, h, EPS)
    assert calls == [] and len(made) == 1


# ---------------------------------------------------------------------------
# rows 21 and 22: the stage-delta base MLP halves of "gelu" and "grad"
# ---------------------------------------------------------------------------

FLIP_RATE = 5e-3  # one-step code flips, as the whole twins' tests allow


def _base_case(seed, dt, l, hidden, c=256):
    """x_b [2, L, C], LN2, w1 [C, hidden] and w2 [hidden, C] as the JAX and
    torch codes with column scales, and biases."""
    r = np.random.default_rng(seed)
    xb = r.standard_normal((2, l, c)).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    b = (0.1 * r.standard_normal(c)).astype(np.float32)
    j1, t1 = _weights(r, c, hidden, 0.1)
    j2, t2 = _weights(r, hidden, c, 0.05)
    b1 = (r.standard_normal(hidden) * 0.02).astype(np.float32)
    b2 = (r.standard_normal(c) * 0.02).astype(np.float32)
    jd, td = DT[dt][:2]
    jargs = (jnp.asarray(s), jnp.asarray(b), *j1, jnp.asarray(b1), *j2,
             jnp.asarray(b2), EPS)
    targs = (torch.from_numpy(s), torch.from_numpy(b), *t1,
             torch.from_numpy(b1), *t2, torch.from_numpy(b2), EPS)
    return (jnp.asarray(xb).astype(jd), torch.from_numpy(xb).to(td), jargs,
            targs)


def _base_twin(x2d, targs, strips, mode):
    """The whole twin of the mode, the code pass, fc1 and fc2 in sequence:
    the outputs of ``base_mlp_block`` in its order."""
    if mode == "grad":
        return tdelta.base_mlp_grad_plain(x2d, *targs, strips)
    return tdelta.base_mlp_e_plain(x2d, *targs, strips, emit_gelu=True)


def _gelu64(e):
    return 0.5 * e * (1.0 + torch.erf(e * 0.5 ** 0.5))


def _gelu_grad64(e):
    return (0.5 * (1.0 + torch.erf(e * 0.5 ** 0.5))
            + e * torch.exp(-0.5 * e * e) * (2 * np.pi) ** -0.5)


def _strips(t, strips):
    """[R, N] as [R, strips, N / strips]."""
    return t.reshape(t.shape[0], strips, -1)


def _held_by_grid(q, scale, zp, ref, strips):
    """Codes ``q`` [R, N] on the per-(row, strip) grid ``scale``, ``zp``
    [R, strips] stand within half a step of ``ref`` in float64, up to the
    f32 arithmetic's own error (the erf polynomial's 1.5e-7 included)."""
    slack = 1e-6 + 1e-5 * ref.abs().amax(dim=1, keepdim=True)
    deq = _strips(q.double(), strips) * scale.double()[..., None]
    if zp is not None:
        deq = deq + zp.double()[..., None]
    err = (deq - _strips(ref, strips)).abs()
    assert (err <= 0.5 * scale.double()[..., None] + slack[..., None]).all()


def _grid_of(ref, strips, affine):
    """The float64 grid of ``ref`` [R, N] per row and strip: the symmetric
    scale amax / 127, or the affine scale max(gmax - gmin, 1e-8) / 254 and
    zero point (gmax + gmin) / 2."""
    r = _strips(ref, strips)
    if not affine:
        return r.abs().amax(dim=2).clamp(min=1e-8) / 127, None
    hi, lo = r.amax(dim=2), r.amin(dim=2)
    return (hi - lo).clamp(min=1e-8) / 254, (hi + lo) / 2


def _same_grid(scale, zp, ref, strips, affine):
    want_s, want_z = _grid_of(ref, strips, affine)
    top = _strips(ref, strips).abs().amax(dim=2)
    np.testing.assert_allclose(_np(scale), _np(want_s), rtol=1e-5,
                               atol=1e-7)
    if affine:
        assert ((zp.double() - want_z).abs() <= 1e-5 * top + 1e-6).all()


@pytest.mark.parametrize("l", [17, 65])
@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("hidden,strips", [(1024, 1), (1024, 2), (768, 3),
                                           (1024, 4)])
@pytest.mark.parametrize("mode", ["grad", "e+g"])
def test_base_mlp_pieces_chain_to_the_twin(mode, hidden, strips, dt, l):
    """Rows 22 and 21: each piece of the chain that makes up the whole twin
    against float64 arithmetic of what it computes. The code pass codes LN2
    of x within half a step of its row scale amax / 127; fc1's e, recomputed
    from those codes, gives the cache (row 22: gelu'(e); row 21: e) coded
    per row and strip, and the hidden (GELU(e); GELU of the coded e) on the
    affine grid, each within half a step of its grid, the grids as their
    float64 statistics say; fc2 folds the strips' products with the colsums
    into m within f32's error (and bf16's rounding), and o = x + m in x's
    dtype."""
    _, tx, _, targs = _base_case(21 + l + strips, dt, l, hidden)
    s, b, w1, s1, b1, w2, s2, b2, eps = targs
    x2d = tx.reshape(-1, tx.shape[-1])
    xq, xs = tdelta.base_codes_plain(x2d, s, b, eps)
    ln = torch.nn.functional.layer_norm(x2d.double(), (x2d.shape[-1],),
                                        eps=eps) * s.double() + b.double()
    _same_grid(xs, None, ln, 1, affine=False)
    _held_by_grid(xq, xs, None, ln, 1)
    e = ((xq.double() @ w1.double()) * xs.double() * s1.double()
         + b1.double())
    if mode == "grad":
        cq, cs, hq, hsc, hzp = tdelta.base_fc1_grad_plain(xq, xs, w1, s1, b1,
                                                          strips)
        cache, g = _gelu_grad64(e), _gelu64(e)
    else:
        cq, cs, hq, hsc, hzp = tdelta.base_fc1_eg_plain(xq, xs, w1, s1, b1,
                                                        strips)
        cache = e
        g = _gelu64(_strips(cq.double(), strips)
                    * cs.double()[..., None]).reshape(e.shape)
    assert cs.shape == hsc.shape == hzp.shape == (x2d.shape[0], strips)
    for q, sc, zp, ref, affine in ((cq, cs, None, cache, False),
                                   (hq, hsc, hzp, g, True)):
        assert q.dtype == torch.int8 and q.shape == ref.shape
        _same_grid(sc, zp, ref, strips, affine)
        _held_by_grid(q, sc, zp, ref, strips)
    o, m = tdelta.base_fc2_plain(hq, hsc, hzp, w2, s2, b2, x2d)
    d = torch.einsum("rjk,jkn->rjn", _strips(hq.double(), strips),
                     w2.double().reshape(strips, -1, w2.shape[1]))
    terms = torch.stack([d * hsc.double()[..., None],
                         hzp.double()[..., None]
                         * w2.double().reshape(strips, -1, w2.shape[1])
                         .sum(dim=1)])
    m64 = terms.sum(dim=(0, 2)) * s2.double() + b2.double()
    bound = terms.abs().sum(dim=(0, 2)) * s2.double().abs() * 1e-6 + 1e-7
    if dt == "bf16":
        bound = bound + m64.abs() * 2.0 ** -8
    assert m.dtype == o.dtype == x2d.dtype
    assert ((m.double() - m64).abs() <= bound).all()
    assert torch.equal(o, x2d + m)


def _codes_close(port, ref):
    d = np.abs(_np(port) - _np(ref))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= FLIP_RATE, (d > 0).mean()


@pytest.mark.parametrize("l", [17, 65])
@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("mode", ["grad", "e+g"])
def test_base_mlp_pieces_hold_the_jax_kernel(mode, dt, l):
    """C 256, hidden 1024 in 4 strips: the pieces' twins in sequence against
    the interpreted ``base_mlp_block`` of the JAX package on every output,
    o on o - x, codes one step apart at a small rate, scales within
    1e-6."""
    jx, tx, jargs, targs = _base_case(22 + l, dt, l, 1024)
    c = tx.shape[-1]
    _, _, atol, rel = DT[dt]
    got = _base_twin(tx.reshape(-1, c), targs, tmlp.col_slices(1024), mode)
    ref = jdelta.base_mlp_block(jx, *jargs, interpret=True, mode=mode)
    assert [tuple(t.shape) for t in got[1:3]] == [a.shape for a in ref[1:3]]
    if dt == "bf16":  # as row 15's bf16 case above: one bf16 step of |o|
        top = float(np.abs(_np(ref[0])).max())
        atol = max(atol, 2.0 ** (np.floor(np.log2(top)) - 7))
    _close(got[0].reshape(tx.shape), ref[0], atol, rel, base=tx)
    _close(got[3].reshape(tx.shape), ref[3], DT[dt][2], rel)
    for i in range(1, len(got)):
        if got[i].dtype == torch.int8:
            _codes_close(got[i], ref[i])
        elif i != 3:
            np.testing.assert_allclose(_np(got[i]), _np(ref[i]), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("mode", ["grad", "e+g", "e"])
def test_base_mlp_block_runs_its_pieces(monkeypatch, mode):
    """Rows 22, 21 and 20's plumbing on the card, the library stubbed: one
    call of the C entry that chains the code pass, fc1 and fc2, with x,
    LN2, both weights (torch layout), the colsums, o, m, the mode's cache
    and one workspace allocation laid out as ``base_ws_sizes`` says (rows 22
    and 20: the row codes, their scales, the hidden codes, their scales and
    zero points; row 21: the row codes and their scales); one launch
    counted; every refusal before any call."""
    calls = _stub(monkeypatch, tdelta)
    made = []
    real = tdelta._base_workspace

    def workspace(dev, sizes):
        made.append((list(sizes), real(dev, sizes)))
        return made[-1][1]
    monkeypatch.setattr(tdelta, "_base_workspace", workspace)
    r, c, hid, strips = 10, 256, 1024, 4
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((r, c)).astype(
        np.float32)).to(torch.bfloat16)
    q1 = tquant.quantized_weight(torch.from_numpy(
        rng.standard_normal((c, hid)).astype(np.float32)))
    q2 = tquant.quantized_weight(torch.from_numpy(
        rng.standard_normal((hid, c)).astype(np.float32)))
    one, b1 = torch.ones(c), torch.zeros(hid)
    w = (one, one, q1.kn, q1.scale, b1, q2.kn, q2.scale, one, EPS, strips)
    tdelta.reset_launches()
    out = tdelta._base_mlp_kernel(x, *w, mode)
    fn = "uspace_" + tdelta.BASE_MODES[mode]
    assert [f for f, _ in calls] == [fn]
    (_, args), = calls
    assert args[0] == x.data_ptr()
    assert args[3] == q1.q.data_ptr() and args[6] == q2.q.data_ptr()
    assert args[10:12] == (out[0].data_ptr(), out[3].data_ptr())
    cache = out[1:3] + out[4:]
    assert len(cache) == (5 if mode == "e+g" else 2)
    assert args[12:12 + len(cache)] == tuple(t.data_ptr() for t in cache)
    assert [t.shape for t in cache[:2]] == [(r, hid), (r, strips)]
    (sizes, ws), = made
    want = [r * c, 4 * r]
    if mode != "e+g":
        want += [r * hid, 4 * r * strips, 4 * r * strips]
    assert sizes == want == tdelta.base_ws_sizes(r, c, hid, strips, mode)
    assert ws.dtype == torch.uint8
    assert ws.numel() == sum(-(-n // 256) * 256 for n in want)
    n = 12 + len(cache)
    assert args[n] == ws.data_ptr()
    assert args[n + 1:n + 6] == (r, c, hid, strips, EPS)
    assert len(args) == n + 7
    assert tdelta.LAUNCHES[tdelta.BASE_MODES[mode]] == 1
    assert sum(tdelta.LAUNCHES.values()) == 1
    # refused before any call or allocation: a strip of 128, an f32 x, a
    # bias of the wrong width
    del calls[:]
    with pytest.raises(ValueError, match="strip width"):
        tdelta._base_mlp_kernel(x, *w[:-1], 8, mode)
    with pytest.raises(ValueError, match="bfloat16"):
        tdelta._base_mlp_kernel(x.float(), *w, mode)
    with pytest.raises(ValueError, match="b1 must have shape"):
        tdelta._base_mlp_kernel(x, *w[:4], b1[:512], *w[5:], mode)
    assert calls == [] and len(made) == 1
    assert tdelta.LAUNCHES[tdelta.BASE_MODES[mode]] == 1
