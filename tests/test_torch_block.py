"""The whole-sub-block route (``attn_impl="pallas_block"``) and the bf16
fused MLP of uspace_tpu_torch, held to the JAX package's.

The plain twins of the four kernels (the bf16 and int8 attention sub-blocks,
the bf16 MLP and MLP sub-block) against the JAX kernels run in interpret
mode on the CPU; the bf16 sub-block's gradient against ``jax.grad``; Block
with ``pallas_block`` in every view, with and without a qkv bias, and a toy
U-ViT on that route, against the JAX modules on one param tree; the three
repairs of the port (``fused_mlp``'s default view, the dispatcher's
model-level impl strings, a config's ``nnet.attn_impl`` in ``sample_lfm``).
Inputs come from numpy seeds.

Tolerances:
- f32: 1e-5 for the MLP twins (the same products, f32 sums in another
  order), 1e-4 for the attention sub-block, its gradient, Block and the
  field (a softmax and two projections of such sums);
- bf16: one bf16 step of the largest output value (JAX on the CPU keeps a
  bf16 chain in f32 where the kernels and the twins round each operation,
  ROADMAP Queue 3), for Block and the field two such steps, rel-L2 5e-3;
- int8 views: max-abs 2e-3 (f32) / 2e-2 (bf16) and rel-L2 1e-4 / 5e-3, as
  tests/test_torch_quant.py: an f32 sum taken in another order may flip one
  int8 code by one step;
- the attention sub-block is compared on its update ``out - x``, which the
  residual would otherwise hide.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.models import layers as jlayers
from uspace_tpu.ops import attention as jattn
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu_torch.cli import sample_lfm, train_lfm
from uspace_tpu_torch.codecs.convert import load_uvit_from_jax, uvit_flax_to_torch
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.models import layers as tlayers
from uspace_tpu_torch.ops import attention as tattn
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops import mlp as tmlp
from uspace_tpu_torch.ops import quant as tquant

H, C, L = 4, 64, 17
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
INT8_TOL = {"f32": (2e-3, 1e-4), "bf16": (2e-2, 5e-3)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _bf16_step(v):
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _close(port, ref, atol, rel=None, base=None):
    """max-abs ``atol`` and, with ``rel``, rel-L2 ``rel`` (of ``x - base``
    for both when ``base`` is given)."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    err = np.abs(p - r).max()
    assert err <= atol, (err, atol)
    if rel is not None:
        if base is not None:
            p, r = p - _np(base), r - _np(base)
        got = np.linalg.norm(p - r) / np.linalg.norm(r)
        assert got <= rel, (got, rel)


def _close_dt(dt, port, ref, f32_tol, steps=1, base=None):
    """f32: max-abs ``f32_tol``; bf16: ``steps`` bf16 steps of max|ref| and
    rel-L2 5e-3 (of the update when ``base`` is given)."""
    if dt == "f32":
        _close(port, ref, f32_tol, f32_tol if base is not None else None,
               base)
    else:
        _close(port, ref, steps * _bf16_step(np.abs(_np(ref)).max()), 5e-3,
               base)


def _mlp_inputs(seed, hidden, c=C, rows=(2, 17)):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((*rows, c)).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(c)).astype(np.float32),
        b=(0.1 * r.standard_normal(c)).astype(np.float32),
        w1=(r.standard_normal((c, hidden)) * 0.1).astype(np.float32),
        b1=(r.standard_normal(hidden) * 0.02).astype(np.float32),
        w2=(r.standard_normal((hidden, c)) * 0.05).astype(np.float32),
        b2=(r.standard_normal(c) * 0.02).astype(np.float32))


def _block_inputs(seed, b=2, l=L, c=C):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((b, l, c)).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(c)).astype(np.float32),
        b=(0.1 * r.standard_normal(c)).astype(np.float32),
        wqkv=(r.standard_normal((c, 3 * c)) * 0.2).astype(np.float32),
        wproj=(r.standard_normal((c, c)) * 0.1).astype(np.float32),
        bproj=(r.standard_normal(c) * 0.1).astype(np.float32))


BLOCK_ARGS = ("x", "s", "b", "wqkv", "wproj", "bproj")


# ---------------------------------------------------------------------------
# rows 12 and 13: the bf16 MLP and MLP sub-block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [250, 384])
@pytest.mark.parametrize("dt", list(DT))
def test_mlp_bf16_twin_matches_jax(dt, hidden):
    """fused_mlp(quant=False): 250 -> 2 strips, 384 -> 4 strips of 96."""
    jd, td = DT[dt]
    a = _mlp_inputs(1, hidden)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp(jnp.asarray(a["x"], jd), *map(jnp.asarray, ws),
                         quant=False, interpret=True)
    with torch.no_grad():
        out = tmlp.fused_mlp(_t(a["x"], td), *map(_t, ws), quant=False)
    assert out.dtype == td and out.shape == a["x"].shape
    _close_dt(dt, out, ref, 1e-5)


@pytest.mark.parametrize("hidden", [250, 384])
@pytest.mark.parametrize("dt", list(DT))
def test_mlp_block_bf16_twin_matches_jax(dt, hidden):
    """fused_mlp_block_q(quant=False): LN2 as the bf16 chain, the bf16
    MLP, the residual."""
    jd, td = DT[dt]
    a = _mlp_inputs(2, hidden)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp_block_q(jnp.asarray(a["x"], jd), jnp.asarray(a["s"]),
                                 jnp.asarray(a["b"]), *map(jnp.asarray, ws),
                                 quant=False, interpret=True)
    with torch.no_grad():
        out = tmlp.fused_mlp_block_q(_t(a["x"], td), _t(a["s"]), _t(a["b"]),
                                     *map(_t, ws), quant=False)
    assert out.dtype == td
    _close_dt(dt, out, ref, 1e-5, base=_t(a["x"], td))


def _three_piece_bf16(x, w1, b1, w2, b2, ln=None):
    """A mirror of the card's bf16 MLP (rows 12 and 13) as its pieces: the
    LN pass (the bf16 chain of LN2, its f32 sums in the kernel's lane order)
    writes xln in x's dtype; the fc1 GEMM's epilogue ``f32(xln . w1) + b1``,
    GELU, rounds h to x's dtype over the whole hidden width at once (no
    strips); the fc2 GEMM's epilogue rounds ``f32(h . w2) + b2`` to x's
    dtype and adds x in x's dtype. Without ``ln`` it is row 12's function on
    x."""
    dt = x.dtype
    xln = x
    if ln is not None:
        xf, c = x.float(), x.shape[-1]
        mu = tquant.true_div(tdelta._lane_sum(xf), c)
        var = tquant.true_div(tdelta._lane_sum(xf * xf), c) - mu * mu
        inv = torch.rsqrt(var + ln[2]).to(dt)
        xln = (x - mu.to(dt)) * inv * ln[0].to(dt) + ln[1].to(dt)
    pre = torch.matmul(xln.float(), w1.to(dt).float()) + b1.float()
    h = tmlp._gelu_f32(pre).to(dt)
    m = (torch.matmul(h.float(), w2.to(dt).float()) + b2.float()).to(dt)
    return m if ln is None else x + m


@pytest.mark.parametrize("hidden", [250, 384])
@pytest.mark.parametrize("lnres", [True, False])
@pytest.mark.parametrize("dt", list(DT))
def test_three_piece_bf16_keeps_the_rounding_sites(dt, lnres, hidden):
    """Rows 12 and 13 as the card runs them (an LN pass, fc1 and fc2 over
    the whole hidden width) against the interpreted JAX kernels
    (_mlp_kernel_bf16_lnres through fused_mlp_block_q, _mlp_kernel_bf16
    through fused_mlp) and against the twins, at the file's tolerances:
    the TPU kernels' hidden strips (2 of 125 or 4 of 96 columns here) only
    order f32 sums, and the lane-order LN sums move no rounding site. In
    bf16 all but a few outputs equal the twin's bit for bit (the hidden kept
    in f32 moves 16-41% of them here)."""
    jd, td = DT[dt]
    a = _mlp_inputs(21 + hidden, hidden)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    x = _t(a["x"], td).reshape(-1, C)
    w1, b1, w2, b2 = map(_t, ws)
    s = tmlp.col_slices(hidden)
    x3 = _t(a["x"], td)
    if lnres:
        ln = (_t(a["s"]), _t(a["b"]), 1e-5)
        ref = jmlp.fused_mlp_block_q(
            jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
            *map(jnp.asarray, ws), quant=False, interpret=True)
        twin = tmlp.ln_mlp_bf16_plain(x, *ln[:2], w1, b1, w2, b2, s, 1e-5)
    else:
        ln = None
        ref = jmlp.fused_mlp(jnp.asarray(a["x"], jd), *map(jnp.asarray, ws),
                             quant=False, interpret=True)
        twin = tmlp.mlp_bf16_plain(x, w1, b1, w2, b2, s)
    mine = _three_piece_bf16(x, w1, b1, w2, b2, ln)
    assert mine.dtype == td
    _close_dt(dt, mine.reshape(x3.shape), ref, 1e-5,
              base=x3 if lnres else None)
    _close_dt(dt, mine, twin, 1e-5, base=x if lnres else None)
    if dt == "bf16":
        assert float((mine != twin).float().mean()) <= 0.01


def test_fused_mlp_defaults_to_bf16_as_in_jax():
    """Repair: fused_mlp with no quant argument is the bf16 MLP in both
    packages (the port used to default to W8A8)."""
    a = _mlp_inputs(3, 256)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp(jnp.asarray(a["x"]), *map(jnp.asarray, ws),
                         interpret=True)
    with torch.no_grad():
        out = tmlp.fused_mlp(_t(a["x"]), *map(_t, ws))
        int8 = tmlp.fused_mlp(_t(a["x"]), *map(_t, ws), quant=True)
    _close(out, ref, 1e-5)
    assert np.abs(_np(int8) - _np(ref)).max() > 1e-4  # another view


def test_bf16_mlp_is_inference_only():
    a = _mlp_inputs(4, 256)
    w1 = _t(a["w1"]).requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tmlp.fused_mlp(_t(a["x"]), w1, _t(a["b1"]), _t(a["w2"]), _t(a["b2"]))
    with pytest.raises(NotImplementedError, match="inference-only"):
        tmlp.fused_mlp_block_q(_t(a["x"]), _t(a["s"]), _t(a["b"]), w1,
                               _t(a["b1"]), _t(a["w2"]), _t(a["b2"]),
                               quant=False)


# ---------------------------------------------------------------------------
# rows 10 and 11: the attention sub-block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DT))
def test_attention_block_twin_matches_jax(dt):
    jd, td = DT[dt]
    a = _block_inputs(5)
    ref = jattn.fused_attention_block(
        *(jnp.asarray(a[k], jd if k == "x" else jnp.float32)
          for k in BLOCK_ARGS), H, interpret=True)
    x = _t(a["x"], td)
    with torch.no_grad():
        out = tattn.fused_attention_block(
            x, *(_t(a[k]) for k in BLOCK_ARGS[1:]), H)
    assert out.dtype == td
    _close_dt(dt, out, ref, 1e-4, base=x)


def test_attention_block_grad_matches_jax():
    """The VJP of the plain recompute with its f32 LN, for all six inputs,
    against jax.grad of the JAX custom VJP (f32)."""
    a = _block_inputs(6)
    g = np.random.default_rng(7).standard_normal(a["x"].shape).astype(
        np.float32)

    def jloss(*args):
        out = jattn.fused_attention_block(*args, H, interpret=True)
        return (out * jnp.asarray(g)).sum()

    ref = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in BLOCK_ARGS))
    ins = [_t(a[k]).requires_grad_() for k in BLOCK_ARGS]
    out = tattn.fused_attention_block(*ins, H)
    got = torch.autograd.grad((out * _t(g)).sum(), ins)
    for name, p, r in zip(BLOCK_ARGS, got, ref):
        scale = max(1.0, np.abs(_np(r)).max())
        assert np.abs(_np(p) - _np(r)).max() <= 1e-4 * scale, name


def _tpu_rounding_block_q_kernel():
    """``_attn_block_kernel_q`` with its two bf16 -> f32 widenings (the LN1
    rows and the attention rows, each coded to int8) kept as bf16 values:
    a TPU holds them in bf16, while XLA on the CPU may elide the round trip
    (``xla_allow_excess_precision``) and code the unrounded f32 chain. Made
    from the reference's own source; the JAX package is not changed."""
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


@pytest.mark.parametrize("dt", list(DT))
def test_attention_block_q_twin_matches_jax(dt, monkeypatch):
    """f32 against the JAX kernel as it is; bf16 against it with its bf16
    values kept bf16 on the CPU too (the unpatched CPU run codes f32 LN rows
    that a TPU never sees: 4.7e-2 max-abs, rel-L2 1.5e-2 here, while the
    patched kernel equals the twin bit for bit)."""
    jd, td = DT[dt]
    atol, rel = INT8_TOL[dt]
    a = _block_inputs(8)
    if dt == "bf16":
        monkeypatch.setattr(jattn, "_attn_block_kernel_q",
                            _tpu_rounding_block_q_kernel())
    ref = jattn.fused_attention_block_q(
        *(jnp.asarray(a[k], jd if k == "x" else jnp.float32)
          for k in BLOCK_ARGS), H, interpret=True)
    x = _t(a["x"], td)
    with torch.no_grad():
        out = tattn.fused_attention_block_q(
            x, *(_t(a[k]) for k in BLOCK_ARGS[1:]), H)
    assert out.dtype == td
    _close(out, ref, atol, rel, base=x)


def test_attention_block_q_is_not_int8_dense():
    """Row 11 codes the attention output as round(a * (127 / amax)) and
    adds an f32 bias; int8_dense divides by a rounded scale: the twin
    follows the kernel, not int8_dense."""
    a = _block_inputs(9)
    ins = [_t(a[k], torch.bfloat16 if k == "x" else torch.float32)
           for k in BLOCK_ARGS]
    qw = tquant.quantized_weight(ins[3])
    with torch.no_grad():
        out = tattn.fused_attention_block_q(*ins, H)
        xln = tmlp._ln_bf16_normalise(ins[0], ins[1], ins[2], 1e-5)
        att = tattn._int8_qkv_attention(xln, qw, H, (C // H) ** -0.5,
                                        torch.bfloat16)
        dense = ins[0] + tquant.int8_dense(att, ins[4], ins[5],
                                           out_dtype=torch.bfloat16)
    assert not torch.equal(out, dense)
    _close(out, dense, 3e-2)


def test_attention_block_q_is_inference_only():
    a = _block_inputs(10)
    ins = [_t(a[k]) for k in BLOCK_ARGS]
    ins[3].requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tattn.fused_attention_block_q(*ins, H)


# ---------------------------------------------------------------------------
# Block and U-ViT on pallas_block vs JAX
# ---------------------------------------------------------------------------

VIEWS = [False, True, "w8", "w8a8_mlp"]


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("view", VIEWS)
def test_block_pallas_block_matches_jax(view, qkv_bias):
    """Every view of Block(attn_impl="pallas_block"), with the skip input,
    against the JAX Block (f32, one param tree loaded strictly)."""
    r = np.random.default_rng(11)
    x = (r.standard_normal((2, L, C)) * 0.5).astype(np.float32)
    sk = (r.standard_normal((2, L, C)) * 0.5).astype(np.float32)
    blk = jlayers.Block(num_heads=H, quant=view, skip=True,
                        qkv_bias=qkv_bias, attn_impl="pallas_block")
    params = blk.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(sk))
    ref = blk.apply(params, jnp.asarray(x), jnp.asarray(sk))
    port = tlayers.Block(C, H, skip=True, qkv_bias=qkv_bias, quant=view,
                         attn_impl="pallas_block", device="cpu")
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in uvit_flax_to_torch(params).items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(_t(x), _t(sk))
    atol, rel = INT8_TOL["f32"] if view else (1e-4, 1e-5)
    _close(out, ref, atol, rel)


def test_block_pallas_block_bf16_matches_jax():
    """The bf16 view in bf16: the sub-block kernel's twin, then the plain
    MLP after LN2."""
    r = np.random.default_rng(12)
    x = (r.standard_normal((2, L, C)) * 0.5).astype(np.float32)
    blk = jlayers.Block(num_heads=H, dtype=jnp.bfloat16,
                        attn_impl="pallas_block")
    params = blk.init(jax.random.PRNGKey(3), jnp.asarray(x, jnp.bfloat16))
    ref = blk.apply(params, jnp.asarray(x, jnp.bfloat16))
    port = tlayers.Block(C, H, dtype=torch.bfloat16,
                         param_dtype=torch.float32, attn_impl="pallas_block",
                         device="cpu")
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in uvit_flax_to_torch(params).items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(_t(x, torch.bfloat16))
    _close_dt("bf16", out, ref, None, steps=2)


def test_block_pallas_block_routes():
    """W8A8 runs the int8 sub-block and the int8 MLP sub-block: the module
    equals those ops on its parameters bit for bit (f32 weights, as the
    view fits its scales on them)."""
    r = np.random.default_rng(13)
    x = _t((r.standard_normal((2, L, C)) * 0.5).astype(np.float32),
           torch.bfloat16)
    torch.manual_seed(4)
    blk = tlayers.Block(C, H, dtype=torch.bfloat16, param_dtype=torch.float32,
                        quant=True, attn_impl="pallas_block", device="cpu")
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.05)
        out = blk(x)
        y = tattn.fused_attention_block_q(
            x, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.t(),
            blk.attn.proj.weight.t(), blk.attn.proj.bias, H)
        ref = tmlp.fused_mlp_block_q(
            y, blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight.t(),
            blk.mlp.fc1.bias, blk.mlp.fc2.weight.t(), blk.mlp.fc2.bias)
    assert torch.equal(out, ref)


TOY = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=C, num_heads=H,
           depth=2)


@pytest.fixture(scope="module")
def toy_params():
    r = np.random.default_rng(14)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.full((2,), 0.3, np.float32)
    p = jax.jit(JaxUViT(attn_impl="pallas_block", **TOY).init)(
        jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(t))
    return jax.tree.map(np.asarray, p), x, t


@pytest.mark.parametrize("view,dt", [(False, "f32"), (False, "bf16"),
                                     (True, "f32"), ("w8", "f32")])
def test_uvit_pallas_block_matches_jax(toy_params, view, dt):
    """A toy U-ViT field on pallas_block, port vs JAX (Pallas interpret),
    the JAX params of a pallas_block U-ViT loaded with strict=True."""
    params, x, t = toy_params
    jd, td = DT[dt]
    ref, _ = JaxUViT(dtype=jd, attn_impl="pallas_block", quant=view,
                     **TOY).apply(params, jnp.asarray(x), jnp.asarray(t))
    m = load_uvit_from_jax(UViT(dtype=td, attn_impl="pallas_block",
                                quant=view, param_dtype=torch.float32,
                                device="cpu", **TOY), params).eval()
    with torch.no_grad():
        out, _ = m(_t(x), _t(t))
    assert out.dtype == td
    if view and view != "w8":
        _close(out, ref, 2e-2, 1e-3)  # int8 flips compound over the blocks
    elif dt == "f32":
        _close(out, ref, 1e-4, 1e-5)
    else:
        _close(out, ref, 6e-2, 1e-2)


# ---------------------------------------------------------------------------
# the dispatcher, the entry points, the launch counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", tattn.MODEL_IMPLS)
def test_dispatcher_maps_model_impls_to_auto(impl):
    """Repair: multi_head_attention takes the model-level strings as
    ``auto`` (uspace_tpu/ops/attention.py:1326-1328)."""
    r = np.random.default_rng(15)
    q, k, v = (_t(r.standard_normal((2, H, L, 16)).astype(np.float32))
               for _ in range(3))
    ref = jattn.multi_head_attention(*(jnp.asarray(_np(a)) for a in (q, k, v)),
                                     impl=impl)
    out = tattn.multi_head_attention(q, k, v, impl=impl)
    assert torch.equal(out, tattn.multi_head_attention(q, k, v, impl="auto"))
    _close(out, ref, 1e-5)


def test_sample_lfm_takes_the_configs_attn_impl(tmp_path):
    """Repair: a config naming nnet.attn_impl builds (no duplicate keyword)
    and samples on the CPU; an explicit attn_impl wins over it."""
    cfg = get_config("synthetic_smoke")
    cfg["nnet"]["attn_impl"] = "pallas_block"
    model = sample_lfm.build_model(cfg, torch.device("cpu"), quant=True)
    assert all(b.attn_impl == "pallas_block" for b in model.in_blocks)
    other = sample_lfm.build_model(cfg, torch.device("cpu"),
                                   attn_impl="xla")
    assert other.mid_block.attn_impl == "xla"
    paths = sample_lfm.run(cfg, n_samples=2, batch=2, steps=2,
                           out=str(tmp_path), device="cpu")
    a = np.load(paths[0])
    assert a.shape == (2, 8, 8, 4) and np.isfinite(a).all()
    sample_lfm.main(["--config", "synthetic_smoke", "--attn_impl",
                     "pallas_block", "--quant", "--n_samples", "1",
                     "--batch", "1", "--steps", "1", "--device", "cpu",
                     "--out", str(tmp_path / "cli")])
    assert np.isfinite(np.load(tmp_path / "cli" / "0.npy")).all()


def test_train_lfm_trains_on_pallas_block(tmp_path):
    """A config's nnet.attn_impl="pallas_block" trains through the bf16
    sub-block and its recompute VJP (the twin on the CPU)."""
    cfg = get_config("synthetic_smoke")
    cfg["nnet"]["attn_impl"] = "pallas_block"
    out = train_lfm.run(cfg, n_steps=2, batch=2, workdir=str(tmp_path),
                        device="cpu", log=lambda _: None)
    assert out["model"].mid_block.attn_impl == "pallas_block"
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    grads = [p.grad for p in out["model"].mid_block.attn.parameters()]
    assert all(g is None or torch.isfinite(g).all() for g in grads)


def test_cpu_block_twins_count_no_launches():
    tattn.reset_launches()
    tmlp.reset_launches()
    a = _block_inputs(16)
    m = _mlp_inputs(17, 256)
    with torch.no_grad():
        ins = [_t(a[k]) for k in BLOCK_ARGS]
        tattn.fused_attention_block(*ins, H)
        tattn.fused_attention_block_q(*ins, H)
        tmlp.fused_mlp(_t(m["x"]), _t(m["w1"]), _t(m["b1"]), _t(m["w2"]),
                       _t(m["b2"]))
        tmlp.fused_mlp_block_q(_t(m["x"]), _t(m["s"]), _t(m["b"]),
                               _t(m["w1"]), _t(m["b1"]), _t(m["w2"]),
                               _t(m["b2"]), quant=False)
    assert set(tattn.LAUNCHES.values()) == {0}
    assert set(tmlp.LAUNCHES.values()) == {0}
    assert {"attention_block", "attention_block_int8"} <= set(tattn.LAUNCHES)
    assert {"mlp_bf16", "ln_mlp_bf16"} <= set(tmlp.LAUNCHES)
