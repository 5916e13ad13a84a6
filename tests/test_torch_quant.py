"""uspace_tpu_torch int8 W8A8 view held to the JAX package's.

The quantizers are bit-equal to JAX's. Each int8 kernel's plain twin is
held to the JAX wrapper run in interpret mode on the CPU, then Block and a
toy U-ViT int8 view to the JAX views on one JAX param tree. Inputs come
from numpy seeds.

Tolerances. The int32 products are exact on both sides, so what differs
is f32 (and bf16) arithmetic summed or fused in another order: LN
statistics, XLA's own reassociation. Where such a difference crosses an
int8 rounding boundary, one code moves by one step (1/127 of its row's
amax, or 1/254 of a hidden strip's range), so no case asks for bit
equality past the quantizers:
- f32 ops: max-abs 2e-3 (a one-step code flip at these sizes moves an
  output by up to ~1e-3) and rel-L2 1e-4 (flips are rare);
- bf16: max-abs 2e-2 (one bf16 step of an O(1-4) value is 8e-3 to 1.6e-2;
  on the CPU XLA keeps the bf16 LN chain of the MLP kernel in f32, where
  the kernel and its twin round each operation) and rel-L2 5e-3;
- a U-ViT field: max-abs 2e-2 (f32) / 6e-2 (bf16) and rel-L2 1e-3 / 1e-2,
  the above compounded over a few blocks.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.models import layers as jlayers
from uspace_tpu.ops import attention as jattn
from uspace_tpu.ops import delta as jdelta
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu.ops import quant as jquant
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import load_uvit_from_jax, uvit_flax_to_torch
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.models import layers as tlayers
from uspace_tpu_torch.ops import attention as tattn
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops import mlp as tmlp
from uspace_tpu_torch.ops import quant as tquant

DT = {"f32": (jnp.float32, torch.float32, 2e-3, 1e-4),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 5e-3)}
H = 4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, atol, rel):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    np.testing.assert_allclose(p, r, rtol=0, atol=atol)
    assert np.linalg.norm(p - r) <= rel * np.linalg.norm(r)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# quantizers and int8_dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "bf16", "zero_rows", "ties"])
def test_quantizers_bit_equal_jax(case):
    r = np.random.default_rng(0)
    x = (r.standard_normal((6, 40)) * 3).astype(np.float32)
    jd, td = jnp.float32, torch.float32
    if case == "bf16":
        jd, td = jnp.bfloat16, torch.bfloat16
    elif case == "zero_rows":
        x[1] = 0.0
        x[:, 3] = 0.0
    elif case == "ties":  # values on the .5 boundaries of the grid
        x[:, :20] = (np.arange(20) - 10 + 0.5) / 127 * np.abs(x).max(
            axis=1, keepdims=True)
    for jfn, tfn in ((jquant.quantize_rowwise, tquant.quantize_rowwise),
                     (jquant.quantize_colwise, tquant.quantize_colwise)):
        jq, js = jfn(jnp.asarray(x, jd))
        tq, ts = tfn(torch.from_numpy(x).to(td))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dt", list(DT))
def test_int8_dense_matches_jax(dt, bias):
    jd, td, atol, rel = DT[dt]
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 9, 48)).astype(np.float32)
    w = (r.standard_normal((48, 40)) * 0.1).astype(np.float32)
    b = (r.standard_normal(40) * 0.1).astype(np.float32) if bias else None
    ref = jquant.int8_dense(jnp.asarray(x, jd), jnp.asarray(w),
                            None if b is None else jnp.asarray(b))
    out = tquant.int8_dense(_t(x, td), _t(w), None if b is None else _t(b))
    assert out.dtype == td
    # same codes, exact int32 products, the same f32 epilogue
    _close(out, ref, 1e-6 if dt == "f32" else atol, 1e-7 if dt == "f32"
           else rel)


def test_int_matmul_exact():
    r = np.random.default_rng(2)
    a = r.integers(-127, 128, (5, 3, 64)).astype(np.int8)
    b = r.integers(-127, 128, (64, 24)).astype(np.int8)
    out = tquant.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32 and out.shape == (5, 3, 24)
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ b)


# ---------------------------------------------------------------------------
# the four kernels' twins vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


def _attn_inputs(seed, b=2, l=17, c=64):
    r = np.random.default_rng(seed)
    return dict(x=r.standard_normal((b, l, c)).astype(np.float32),
                w=(r.standard_normal((c, 3 * c)) * 0.2).astype(np.float32),
                s=(1 + 0.1 * r.standard_normal(c)).astype(np.float32),
                b=(0.1 * r.standard_normal(c)).astype(np.float32))


@pytest.mark.parametrize("l", [17, 257])
@pytest.mark.parametrize("dt", list(DT))
def test_ln_qkvproj_int8_twin_matches_jax(dt, l):
    jd, td, atol, rel = DT[dt]
    a = _attn_inputs(3, l=l)
    ref = jattn.fused_ln_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w"]), H, quant=True, interpret=True)
    with torch.no_grad():
        out = tattn.fused_ln_qkvproj_attention(
            _t(a["x"], td), _t(a["s"]), _t(a["b"]), _t(a["w"]), H, quant=True)
    assert out.dtype == td
    _close(out, ref, atol, rel)


def _three_piece_ln_int8(x, lns, lnb, qw, heads, eps=1e-5):
    """A mirror of the card's int8 LN + QKV-projection route (row 5) as its
    three launches: the code pass (the f32 LN1 rows with their sums in the
    kernel's lane order, ``delta.ln_lanes``, coded by ``row_codes``), the
    int32 product with the epilogue ``bf16((f32(acc) * sr) * ws)`` into the
    qkv workspace, and the packed core. Returns (out, the f32 LN rows,
    codes, sr)."""
    b, l, c = x.shape
    u = tdelta.ln_lanes(x.reshape(-1, c), lns, lnb, eps)
    codes, sr = tquant.row_codes(u)
    qkv = ((tquant.int_matmul(codes, qw.kn).float() * sr) * qw.scale).to(
        x.dtype)
    out = tattn.packed_attention_plain(qkv.reshape(b, l, 3 * c), heads,
                                       (c // heads) ** -0.5)
    return out, u, codes, sr


@pytest.mark.parametrize("l", [17, 257])
@pytest.mark.parametrize("dt", list(DT))
def test_three_piece_ln_int8_keeps_the_rounding_sites(dt, l):
    """Row 5's pieces in sequence against the interpreted JAX kernel
    (_qkv_attn_kernel_qln through fused_ln_qkvproj_attention), H = 2,
    C = 128. The codes and row scales equal JAX's (the TPU kernel's own
    expressions, delta._ln_f32 and _rowquant) bit for bit on every row whose
    f32 LN values agree; where XLA adds the LN sums in another order a code
    may move by one step. The output: in f32 at the file's int8 tolerances
    (test_ln_qkvproj_int8_twin_matches_jax's); in bf16 at its rel-L2 and no
    further in max-abs from JAX than one bf16 step of the largest output or
    the twin's own distance: at C = 128 the interpreted kernel keeps its
    bf16 qkv and P in f32 (XLA's excess precision on the CPU), and the twin
    itself reads up to 0.055 from it at some seeds."""
    jd, td, atol, rel = DT[dt]
    heads, c = 2, 128
    a = _attn_inputs(21 + l, l=l, c=c)
    qw = tquant.quantized_weight(_t(a["w"]))
    args = (_t(a["x"], td), _t(a["s"]), _t(a["b"]))
    out, u, codes, sr = _three_piece_ln_int8(*args, qw, heads)
    xj = jnp.asarray(a["x"], jd)
    ref = jattn.fused_ln_qkvproj_attention(
        xj, jnp.asarray(a["s"]), jnp.asarray(a["b"]), jnp.asarray(a["w"]),
        heads, quant=True, interpret=True)
    uj = jdelta._ln_f32(xj.reshape(-1, c), jnp.asarray(a["s"])[None],
                        jnp.asarray(a["b"])[None], 1e-5)
    jq, js = jdelta._rowquant(uj)
    same = (u.numpy() == np.asarray(uj)).all(axis=-1)
    assert same.any()
    np.testing.assert_array_equal(codes.numpy()[same], np.asarray(jq)[same])
    np.testing.assert_array_equal(sr.numpy()[same], np.asarray(js)[same])
    flips = np.abs(codes.numpy().astype(int) - np.asarray(jq).astype(int))
    assert flips.max() <= 1 and (flips > 0).mean() <= 1e-3
    assert out.dtype == td
    if dt == "f32":
        _close(out, ref, atol, rel)
        return
    twin = tattn.ln_qkvproj_attention_int8_plain(*args, qw, heads,
                                                 (c // heads) ** -0.5, 1e-5)
    r = _np(ref)
    step = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
    limit = max(step, float(np.abs(_np(twin) - r).max()))
    _close(out, ref, limit, rel)


@pytest.mark.parametrize("dt", list(DT))
def test_qkvproj_int8_twin_matches_jax(dt):
    jd, td, atol, rel = DT[dt]
    a = _attn_inputs(4)
    ref = jattn.fused_qkvproj_attention(jnp.asarray(a["x"], jd),
                                        jnp.asarray(a["w"]), H, quant=True,
                                        interpret=True)
    with torch.no_grad():
        out = tattn.fused_qkvproj_attention(_t(a["x"], td), _t(a["w"]), H,
                                            quant=True)
    _close(out, ref, atol, rel)


def _mlp_inputs(seed, hidden=256, rows=(2, 50), c=64):
    r = np.random.default_rng(seed)
    return dict(
        x=(r.standard_normal((*rows, c))).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(c)).astype(np.float32),
        b=(0.1 * r.standard_normal(c)).astype(np.float32),
        w1=(r.standard_normal((c, hidden)) * 0.1).astype(np.float32),
        b1=(r.standard_normal(hidden) * 0.02).astype(np.float32),
        w2=(r.standard_normal((hidden, c)) * 0.05).astype(np.float32),
        b2=(r.standard_normal(c) * 0.02).astype(np.float32))


@pytest.mark.parametrize("hidden", [256, 250])
@pytest.mark.parametrize("dt", list(DT))
def test_mlp_block_int8_twin_matches_jax(dt, hidden):
    """LN2 + int8 MLP + residual; hidden 250 takes 2 strips of 125."""
    jd, td, atol, rel = DT[dt]
    a = _mlp_inputs(5, hidden)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp_block_q(jnp.asarray(a["x"], jd), jnp.asarray(a["s"]),
                                 jnp.asarray(a["b"]),
                                 *map(jnp.asarray, ws), interpret=True)
    with torch.no_grad():
        out = tmlp.fused_mlp_block_q(_t(a["x"], td), _t(a["s"]), _t(a["b"]),
                                     *map(_t, ws))
    assert out.dtype == td and out.shape == a["x"].shape
    _close(out, ref, atol, rel)


@pytest.mark.parametrize("hidden", [256, 250, 384])
@pytest.mark.parametrize("dt", list(DT))
def test_mlp_int8_twin_matches_jax(dt, hidden):
    """Without LN or residual; 250 -> 2 strips, 384 -> 4 strips of 96."""
    jd, td, atol, rel = DT[dt]
    a = _mlp_inputs(6, hidden)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp(jnp.asarray(a["x"], jd), *map(jnp.asarray, ws),
                         quant=True, interpret=True)
    with torch.no_grad():
        out = tmlp.fused_mlp(_t(a["x"], td), *map(_t, ws), quant=True)
    assert out.dtype == td
    _close(out, ref, atol, rel)


def test_strip_count_rule():
    for hidden, want in ((4096, 4), (250, 2), (375, 3), (7, 1), (384, 4)):
        assert tmlp.col_slices(hidden) == want


# ---------------------------------------------------------------------------
# Block and U-ViT int8 views vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dt", list(DT))
def test_block_int8_lnmlp_matches_jax(dt, skip):
    jd, td, atol, rel = DT[dt]
    r = np.random.default_rng(7)
    x = (r.standard_normal((2, 17, 64)) * 0.5).astype(np.float32)
    sk = (r.standard_normal((2, 17, 64)) * 0.5).astype(np.float32)
    blk = jlayers.Block(num_heads=H, dtype=jd, quant=True, skip=skip,
                        attn_impl="pallas_lnmlp")
    args = (jnp.asarray(x, jd),) + ((jnp.asarray(sk, jd),) if skip else ())
    params = blk.init(jax.random.PRNGKey(0), *args)
    ref = blk.apply(params, *args)
    port = tlayers.Block(64, H, skip=skip, dtype=td,
                         param_dtype=torch.float32, quant=True,
                         attn_impl="pallas_lnmlp", device="cpu")
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in uvit_flax_to_torch(params).items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(_t(x, td), _t(sk, td) if skip else None)
    _close(out, ref, atol, rel)


TOY = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=64, num_heads=4,
           depth=2)


@pytest.fixture(scope="module")
def toy_params():
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.full((2,), 0.3, np.float32)
    p = jax.jit(JaxUViT(**TOY).init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                     jnp.asarray(t))
    return jax.tree.map(np.asarray, p), x, t


@pytest.mark.parametrize("view,impl,dt", [
    (True, "pallas_lnmlp", "f32"),
    (True, "pallas_lnmlp", "bf16"),
    (True, "pallas_qkvproj", "f32"),
    (True, "pallas_packed", "f32"),
    (True, "xla", "f32"),  # also `auto` on the CPU, in both packages
    ("w8a8_mlp", "pallas_lnmlp", "f32"),
    ("w8a8_mlp", "xla", "f32"),
])
def test_uvit_int8_view_matches_jax(toy_params, view, impl, dt):
    """A toy U-ViT int8 view, port vs JAX (Pallas interpret), one tree."""
    params, x, t = toy_params
    jd, td, _, _ = DT[dt]
    atol, rel = (2e-2, 1e-3) if dt == "f32" else (6e-2, 1e-2)
    ref, _ = JaxUViT(dtype=jd, attn_impl=impl, quant=view, **TOY).apply(
        params, jnp.asarray(x), jnp.asarray(t))
    m = load_uvit_from_jax(UViT(dtype=td, attn_impl=impl, quant=view,
                                device="cpu", **TOY), params).eval()
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        out, _ = m(_t(x), _t(t))
    assert out.dtype == td
    _close(out, ref, atol, rel)


def test_one_tree_loads_into_both_views(toy_params):
    """The int8 view shares the bf16 view's param tree (strict load)."""
    params, _, _ = toy_params
    a = load_uvit_from_jax(UViT(device="cpu", **TOY), params)
    b = load_uvit_from_jax(UViT(quant=True, device="cpu", **TOY), params)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


# ---------------------------------------------------------------------------
# the f32 grid, the weight cache, refusals, the CLI
# ---------------------------------------------------------------------------


def test_attention_fits_int8_scales_on_f32_weight():
    """The port's counterpart of test_quant.py:117-172: the fused int8
    routes quantize the f32 weight (Int8Dense semantics), not a bf16 copy:
    module output equals the ops called on the raw f32 weights bitwise,
    and the bf16-cast grid differs."""
    r = np.random.default_rng(9)
    x = _t((r.standard_normal((2, 17, 64)) * 0.5).astype(np.float32),
           torch.bfloat16)
    torch.manual_seed(0)
    attn = tlayers.Attention(64, H, dtype=torch.bfloat16,
                             param_dtype=torch.float32, quant=True,
                             attn_impl="pallas_qkvproj", device="cpu")
    with torch.no_grad():
        attn.qkv.weight.normal_(0, 0.05)
        attn.proj.weight.normal_(0, 0.05)
        attn.proj.bias.normal_(0, 0.02)
        out = attn(x)
        k = attn.qkv.weight.t()
        qa, _ = tquant.quantize_colwise(k)
        qb, _ = tquant.quantize_colwise(k.to(torch.bfloat16))
        assert (qa != qb).any()
        a = tattn.fused_qkvproj_attention(x, k.clone(), H, quant=True)
        ref = tquant.int8_dense(a, attn.proj.weight.t().clone(),
                                attn.proj.bias, out_dtype=torch.bfloat16)
    assert torch.equal(out, ref)


def test_lnfused_block_fits_int8_scales_on_f32_weight():
    r = np.random.default_rng(10)
    x = _t((r.standard_normal((2, 17, 64)) * 0.5).astype(np.float32),
           torch.bfloat16)
    torch.manual_seed(1)
    blk = tlayers.Block(64, H, dtype=torch.bfloat16,
                        param_dtype=torch.float32, quant=True,
                        attn_impl="pallas_lnmlp", device="cpu")
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.05)
        out = blk(x)
        a = tattn.fused_ln_qkvproj_attention(
            x, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.t(), H,
            quant=True)
        y = x + tquant.int8_dense(a, blk.attn.proj.weight.t(),
                                  blk.attn.proj.bias, out_dtype=torch.bfloat16)
        ref = tmlp.fused_mlp_block_q(
            y, blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight.t(),
            blk.mlp.fc1.bias, blk.mlp.fc2.weight.t(), blk.mlp.fc2.bias)
    assert torch.equal(out, ref)


def test_weight_cache_quantizes_once_per_value():
    lin = torch.nn.Linear(32, 48)
    w = lin.weight.t()
    tquant.reset_quantizations()
    q1 = tquant.quantized_weight(w)
    assert tquant.quantized_weight(lin.weight.t()) is q1  # a new view
    assert tquant.QUANTIZATIONS["weights"] == 1
    with torch.no_grad():
        lin.weight.mul_(2.0)  # in place: the version moves
    q2 = tquant.quantized_weight(lin.weight.t())
    assert q2 is not q1 and tquant.QUANTIZATIONS["weights"] == 2
    torch.testing.assert_close(q2.scale, 2 * q1.scale)
    sd = {k: v.clone() * 3 for k, v in lin.state_dict().items()}
    lin.load_state_dict(sd)
    q3 = tquant.quantized_weight(lin.weight.t())
    assert q3 is not q2 and tquant.QUANTIZATIONS["weights"] == 3
    np.testing.assert_array_equal(
        q3.q.numpy(), tquant.quantize_colwise(lin.weight.t())[0].t().numpy())
    # the codes' per-strip column sums, as the MLP kernel's epilogue uses
    cs = q3.colsums(2)
    np.testing.assert_array_equal(
        cs.numpy(), q3.q.reshape(48, 2, 16).sum(-1).t().numpy())
    # new storage under the same parameter (as a move to another device)
    lin.weight.data = lin.weight.data.clone()
    assert tquant.quantized_weight(lin.weight.t()) is not q3
    assert tquant.QUANTIZATIONS["weights"] == 4
    held = weakref.ref(tquant.quantized_weight(lin.weight.t()))
    del lin, w, q1, q2, q3
    gc.collect()
    assert held() is None  # the codes died with their parameter


def test_model_views_reuse_the_cache():
    m = UViT(quant=True, device="cpu", **TOY).init_weights(
        torch.Generator().manual_seed(0)).eval()
    x, t = torch.zeros(1, 8, 8, 4), torch.full((1,), 0.5)
    with torch.no_grad():
        a, _ = m(x, t)
        tquant.reset_quantizations()
        b, _ = m(x, t)
        assert tquant.QUANTIZATIONS["weights"] == 0
        assert torch.equal(a, b)
        m.load_state_dict({k: v * 1.5 for k, v in m.state_dict().items()})
        m(x, t)
    # 3 blocks: 2 MLP weights each, 1 skip_linear (CPU auto: bf16 attention)
    assert tquant.QUANTIZATIONS["weights"] == 7


def test_unported_quant_options_raise():
    # pallas_block, once refused here, runs in every view
    # (tests/test_torch_block.py)
    for view in (True, "w8"):
        blk = tlayers.Block(64, H, quant=view, attn_impl="pallas_block")
        with torch.no_grad():
            assert blk(torch.zeros(1, 3, 64)).shape == (1, 3, 64)
    with pytest.raises(ValueError, match="quant view"):
        tlayers.Block(64, H, quant="int4")
    x = torch.zeros(4, 64)
    w1, w2 = torch.zeros(64, 256), torch.zeros(256, 64)
    # the bf16 fused MLP (quant=False), once refused here, runs
    with torch.no_grad():
        assert tmlp.fused_mlp(x, w1, w1[0], w2, w2[0],
                              quant=False).shape == (4, 64)
        assert tmlp.fused_mlp_block_q(x, w2[0], w2[0], w1, w1[0], w2, w2[0],
                                      quant=False).shape == (4, 64)
    with pytest.raises(ValueError, match="MLP view"):
        tmlp.fused_mlp(x, w1, w1[0], w2, w2[0], quant="int4")
    with pytest.raises(NotImplementedError, match="inference-only"):
        tmlp.fused_mlp(x, w1.requires_grad_(), w1[0], w2, w2[0], quant=True)
    # the w8 view, once refused here, runs (tests/test_torch_w8.py)
    with torch.no_grad():
        tmlp.fused_mlp(x, w1, w1[0], w2, w2[0], quant="w8")
    UViT(quant="w8", device="cpu", **TOY)


def test_cpu_int8_twins_do_not_count_launches():
    tattn.reset_launches()
    tmlp.reset_launches()
    with torch.no_grad():
        a = _attn_inputs(11)
        tattn.fused_qkvproj_attention(_t(a["x"]), _t(a["w"]), H, quant=True)
        m = _mlp_inputs(12)
        tmlp.fused_mlp(_t(m["x"]), _t(m["w1"]), _t(m["b1"]), _t(m["w2"]),
                       _t(m["b2"]), quant=True)
    assert set(tattn.LAUNCHES.values()) == {0}
    assert tmlp.LAUNCHES == {"mlp_int8": 0, "ln_mlp_int8": 0, "mlp_w8": 0,
                             "ln_mlp_w8": 0, "mlp_bf16": 0, "ln_mlp_bf16": 0}


def test_sample_lfm_quant_on_cpu(tmp_path):
    """The entry point samples the int8 view on the CPU (twins): f32
    parameters, finite latents of the config's shape."""
    cfg = get_config("synthetic_smoke")
    model = sample_lfm.build_model(cfg, torch.device("cpu"), quant=True)
    assert model.quant is True
    assert all(p.dtype == torch.float32 for p in model.parameters())
    paths = sample_lfm.run("synthetic_smoke", n_samples=3, batch=2, steps=2,
                           out=str(tmp_path), device="cpu", quant="w8a8")
    arrays = [np.load(p) for p in paths]
    assert [a.shape for a in arrays] == [(2, 8, 8, 4), (1, 8, 8, 4)]
    assert all(np.isfinite(a).all() for a in arrays)
