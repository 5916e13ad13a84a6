"""uspace_tpu_torch's weight-only int8 ("w8") view held to the JAX
package's.

The two w8 kernels' plain twins against the JAX wrappers run in interpret
mode on the CPU, then Block and a toy U-ViT w8 view against the JAX views
on one JAX param tree, and the slice as a whole: a dopri5 decode of the toy
w8 U-ViT against the JAX host loop on the JAX w8 field. Inputs come from
numpy seeds.

Tolerances. Weights are the same int8 codes and f32 scales on both sides
and activations are never quantized, so what differs is f32 summation
order and, in bf16, where each side rounds: JAX on the CPU keeps the bf16
LN chain of the kernel in f32, where the kernel and its twin round each
operation. So f32 is held to 1e-5 (ops) and 1e-4 (a field, a solve), and
bf16 to one bf16 step of the largest output (rel-L2 5e-3), as the int8
view's tests hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.core import solvers as jsolvers
from uspace_tpu.models import UViT as JaxUViT
from uspace_tpu.models import layers as jlayers
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu_torch.cli import sample_lfm
from uspace_tpu_torch.codecs.convert import load_uvit_from_jax, uvit_flax_to_torch
from uspace_tpu_torch.configs import get_config
from uspace_tpu_torch.core import flow as tflow
from uspace_tpu_torch.models import UViT
from uspace_tpu_torch.models import layers as tlayers
from uspace_tpu_torch.ops import delta as tdelta
from uspace_tpu_torch.ops import mlp as tmlp
from uspace_tpu_torch.ops import quant as tquant

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
H = 4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, dt, f32_atol=1e-5):
    """f32: ``f32_atol``; bf16: one bf16 step of max|ref|, rel-L2 5e-3."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    if dt == "f32":
        np.testing.assert_allclose(p, r, rtol=0, atol=f32_atol)
        return
    top = float(np.abs(r).max())
    np.testing.assert_allclose(p, r, rtol=0,
                               atol=2.0 ** (np.floor(np.log2(top)) - 7))
    assert np.linalg.norm(p - r) <= 5e-3 * np.linalg.norm(r)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _mlp_inputs(seed, hidden=256, c=64, out=None):
    r = np.random.default_rng(seed)
    out = out or c
    return dict(
        x=r.standard_normal((2, 50, c)).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(c)).astype(np.float32),
        b=(0.1 * r.standard_normal(c)).astype(np.float32),
        w1=(r.standard_normal((c, hidden)) * 0.1).astype(np.float32),
        b1=(r.standard_normal(hidden) * 0.02).astype(np.float32),
        w2=(r.standard_normal((hidden, out)) * 0.05).astype(np.float32),
        b2=(r.standard_normal(out) * 0.02).astype(np.float32))


# ---------------------------------------------------------------------------
# the two kernels' twins vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [256, 250])
@pytest.mark.parametrize("dt", list(DT))
def test_mlp_block_w8_twin_matches_jax(dt, hidden):
    """LN2 + w8 MLP + residual (row 16); hidden 250 takes 2 strips."""
    jd, td = DT[dt]
    a = _mlp_inputs(1, hidden)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp_block_q(jnp.asarray(a["x"], jd), jnp.asarray(a["s"]),
                                 jnp.asarray(a["b"]), *map(jnp.asarray, ws),
                                 interpret=True, quant="w8")
    with torch.no_grad():
        out = tmlp.fused_mlp_block_q(_t(a["x"], td), _t(a["s"]), _t(a["b"]),
                                     *map(_t, ws), quant="w8")
    assert out.dtype == td and out.shape == a["x"].shape
    _close(out, ref, dt)


@pytest.mark.parametrize("hidden,out", [(256, 64), (250, 64), (384, 96)])
@pytest.mark.parametrize("dt", list(DT))
def test_mlp_w8_twin_matches_jax(dt, hidden, out):
    """Without LN or residual (row 17); 384 takes 4 strips of 96, and the
    output width may differ from the input's."""
    jd, td = DT[dt]
    a = _mlp_inputs(2, hidden, out=out)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    ref = jmlp.fused_mlp(jnp.asarray(a["x"], jd), *map(jnp.asarray, ws),
                         quant="w8", interpret=True)
    with torch.no_grad():
        res = tmlp.fused_mlp(_t(a["x"], td), *map(_t, ws), quant="w8")
    assert res.dtype == td and res.shape == (2, 50, out)
    _close(res, ref, dt)


def _three_piece_w8(x, q1, b1, q2, b2, ln=None):
    """A mirror of the card's w8 MLP sub-block (row 16) as three pieces: the
    LN pass (the bf16 chain of LN2, its f32 sums in the kernel's lane order)
    writes xln in x's dtype; the fc1 GEMM's epilogue ``f32(xln . q1^T) * s1
    + b1``, GELU, rounds h to x's dtype; the fc2 GEMM sums ``f32(h . q2^T)``
    over the whole hidden width at once (no strips), and its epilogue rounds
    ``acc * s2 + b2`` to x's dtype and adds x in x's dtype. Without ``ln``
    it is the LN-free function of row 17 on x."""
    dt = x.dtype
    xln = x
    if ln is not None:
        xf, c = x.float(), x.shape[-1]
        mu = tquant.true_div(tdelta._lane_sum(xf), c)
        var = tquant.true_div(tdelta._lane_sum(xf * xf), c) - mu * mu
        inv = torch.rsqrt(var + ln[2]).to(dt)
        xln = (x - mu.to(dt)) * inv * ln[0].to(dt) + ln[1].to(dt)
    pre = torch.matmul(xln.float(), q1.q.float().t())
    h = tmlp._gelu_f32(pre * q1.scale + b1.float()).to(dt)
    acc = torch.matmul(h.float(), q2.q.float().t())
    m = (acc * q2.scale + b2.float()).to(dt)
    return m if ln is None else x + m


@pytest.mark.parametrize("hidden", [256, 512])
@pytest.mark.parametrize("lnres", [True, False])
@pytest.mark.parametrize("dt", list(DT))
def test_three_piece_w8_keeps_the_rounding_sites(dt, lnres, hidden):
    """Row 16's pieces in sequence (and row 17's function without LN),
    against the interpreted JAX kernels (_mlp_kernel_w8_lnres through
    fused_mlp_block_q, _mlp_kernel_w8 through fused_mlp) at the file's
    tolerances, and against the twins: the strips of the TPU kernel and
    the twin only order f32 sums, and the lane-order LN sums move no
    rounding site."""
    jd, td = DT[dt]
    a = _mlp_inputs(11 + hidden, hidden, c=128)
    ws = [a[k] for k in ("w1", "b1", "w2", "b2")]
    x = _t(a["x"], td).reshape(-1, 128)
    q1 = tquant.quantized_weight(_t(a["w1"]))
    q2 = tquant.quantized_weight(_t(a["w2"]))
    b1, b2 = _t(a["b1"]), _t(a["b2"])
    s = tmlp.col_slices(hidden)
    if lnres:
        ln = (_t(a["s"]), _t(a["b"]), 1e-5)
        ref = jmlp.fused_mlp_block_q(
            jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
            *map(jnp.asarray, ws), interpret=True, quant="w8")
        twin = tmlp.ln_mlp_w8_plain(x, *ln[:2], q1, b1, q2, b2, s, 1e-5)
    else:
        ln = None
        ref = jmlp.fused_mlp(jnp.asarray(a["x"], jd), *map(jnp.asarray, ws),
                             quant="w8", interpret=True)
        twin = tmlp.mlp_w8_plain(x, q1, b1, q2, b2, s)
    mine = _three_piece_w8(x, q1, b1, q2, b2, ln)
    assert mine.dtype == td
    _close(mine.reshape(a["x"].shape), ref, dt)
    _close(mine, twin, dt)


def test_w8_is_the_mlp_of_the_dequantized_weights():
    """In f32 the w8 MLP is the plain MLP on ``q * s`` (activations are
    never quantized: that is its whole content, as the JAX package's test
    says), and it sits strictly closer to the exact MLP than W8A8."""
    a = _mlp_inputs(3)
    x, w1, b1, w2, b2 = (_t(a[k]) for k in ("x", "w1", "b1", "w2", "b2"))
    with torch.no_grad():
        out = tmlp.fused_mlp(x, w1, b1, w2, b2, quant="w8")
        q1, s1 = tquant.quantize_colwise(w1)
        q2, s2 = tquant.quantize_colwise(w2)
        deq = tmlp._gelu_f32(x @ (q1.float() * s1) + b1) @ (
            q2.float() * s2) + b2
        exact = tmlp._gelu_f32(x @ w1 + b1) @ w2 + b2
        w8a8 = tmlp.fused_mlp(x, w1, b1, w2, b2, quant=True)
    np.testing.assert_allclose(out.numpy(), deq.numpy(), rtol=0, atol=1e-5)
    rel = lambda o: float((o - exact).norm() / exact.norm())
    assert rel(out) < rel(w8a8)


# ---------------------------------------------------------------------------
# Block and U-ViT w8 views vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dt", list(DT))
def test_block_w8_lnmlp_matches_jax(dt, skip):
    """The LN-fused route: bf16 LN + QKV-projection attention, bf16 proj,
    the w8 MLP sub-block; skip_linear stays a bf16 Dense."""
    jd, td = DT[dt]
    r = np.random.default_rng(4)
    x = (r.standard_normal((2, 17, 64)) * 0.5).astype(np.float32)
    sk = (r.standard_normal((2, 17, 64)) * 0.5).astype(np.float32)
    blk = jlayers.Block(num_heads=H, dtype=jd, quant="w8", skip=skip,
                        attn_impl="pallas_lnmlp")
    args = (jnp.asarray(x, jd),) + ((jnp.asarray(sk, jd),) if skip else ())
    params = blk.init(jax.random.PRNGKey(0), *args)
    ref = blk.apply(params, *args)
    port = tlayers.Block(64, H, skip=skip, dtype=td,
                         param_dtype=torch.float32, quant="w8",
                         attn_impl="pallas_lnmlp", device="cpu")
    assert port.skip_linear is None or not port.skip_linear.quant
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in uvit_flax_to_torch(params).items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(_t(x, td), _t(sk, td) if skip else None)
    _close(out, ref, dt, f32_atol=1e-4)


def test_qkv_bias_lnmlp_sends_both_mlp_views_to_w8():
    """With a qkv bias, ``pallas_lnmlp`` takes the unfused attention and
    then the w8 MLP sub-block, for ``w8`` and for ``w8a8_mlp`` alike (the
    JAX routing, uspace_tpu/models/layers.py:498-509)."""
    r = np.random.default_rng(5)
    x = _t((r.standard_normal((2, 9, 64)) * 0.5).astype(np.float32))
    for view in ("w8", "w8a8_mlp"):
        torch.manual_seed(2)
        blk = tlayers.Block(64, H, qkv_bias=True, quant=view,
                            attn_impl="pallas_lnmlp", device="cpu")
        with torch.no_grad():
            for p in blk.parameters():
                p.normal_(0, 0.05)
            out = blk(x)
            y = x + blk.attn(blk.norm1(x))
            ref = tmlp.fused_mlp_block_q(
                y, blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight.t(),
                blk.mlp.fc1.bias, blk.mlp.fc2.weight.t(), blk.mlp.fc2.bias,
                quant="w8")
        assert torch.equal(out, ref)


TOY = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=64, num_heads=4,
           depth=2)


@pytest.fixture(scope="module")
def toy_params():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.full((2,), 0.3, np.float32)
    p = jax.jit(JaxUViT(**TOY).init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                     jnp.asarray(t))
    return jax.tree.map(np.asarray, p), x, t


@pytest.mark.parametrize("impl,dt", [
    ("auto", "f32"),  # the LN-free route on the CPU, in both packages
    ("pallas_lnmlp", "f32"),
    ("pallas_lnmlp", "bf16"),
    ("xla", "bf16"),
    ("pallas_qkvproj", "f32"),
])
def test_uvit_w8_view_matches_jax(toy_params, impl, dt):
    """A toy U-ViT w8 view, port vs JAX (Pallas interpret), one tree."""
    params, x, t = toy_params
    jd, td = DT[dt]
    ref, _ = JaxUViT(dtype=jd, attn_impl=impl, quant="w8", **TOY).apply(
        params, jnp.asarray(x), jnp.asarray(t))
    m = load_uvit_from_jax(UViT(dtype=td, attn_impl=impl, quant="w8",
                                device="cpu", **TOY), params).eval()
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        out, _ = m(_t(x), _t(t))
    assert out.dtype == td
    _close(out, ref, dt, f32_atol=1e-4)


def test_w8_view_shares_the_param_tree(toy_params):
    """One tree loads strictly into the bf16 view and the w8 view."""
    params, _, _ = toy_params
    a = load_uvit_from_jax(UViT(device="cpu", **TOY), params)
    b = load_uvit_from_jax(UViT(quant="w8", device="cpu", **TOY), params)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_w8_field_is_closer_to_bf16_than_w8a8():
    """The port's counterpart of tests/test_quant.py:274-297: on the same
    weights the w8 field sits strictly closer to the full-precision field
    than the W8A8 one, and close to it."""
    kw = dict(img_size=16, patch_size=2, in_chans=4, embed_dim=64, depth=4,
              num_heads=4, device="cpu")
    ref_m = UViT(**kw).init_weights(torch.Generator().manual_seed(3)).eval()
    views = {q: UViT(quant=q, attn_impl="pallas_lnmlp", **kw).eval()
             for q in ("w8", True)}
    x = torch.randn(2, 16, 16, 4, generator=torch.Generator().manual_seed(4))
    t = torch.full((2,), 0.4)
    with torch.no_grad():
        ref, _ = ref_m(x, t)
        outs = {}
        for q, m in views.items():
            m.load_state_dict(ref_m.state_dict())
            outs[q], _ = m(x, t)
    rel = {q: float((o - ref).norm() / ref.norm()) for q, o in outs.items()}
    cos = float((outs["w8"] * ref).sum() / (outs["w8"].norm() * ref.norm()))
    assert cos > 0.995 and rel["w8"] < rel[True]


def test_w8_weights_are_quantized_once():
    m = UViT(quant="w8", device="cpu", **TOY).init_weights(
        torch.Generator().manual_seed(0)).eval()
    x, t = torch.zeros(1, 8, 8, 4), torch.full((1,), 0.5)
    with torch.no_grad():
        a, _ = m(x, t)
        tquant.reset_quantizations()
        b, _ = m(x, t)
    assert tquant.QUANTIZATIONS["weights"] == 0 and torch.equal(a, b)


def test_cpu_w8_twins_do_not_count_launches():
    tmlp.reset_launches()
    a = _mlp_inputs(7)
    ws = [_t(a[k]) for k in ("w1", "b1", "w2", "b2")]
    with torch.no_grad():
        tmlp.fused_mlp(_t(a["x"]), *ws, quant="w8")
        tmlp.fused_mlp_block_q(_t(a["x"]), _t(a["s"]), _t(a["b"]), *ws,
                               quant="w8")
    assert set(tmlp.LAUNCHES.values()) == {0}
    with pytest.raises(NotImplementedError, match="inference-only"):
        tmlp.fused_mlp(_t(a["x"]), ws[0].requires_grad_(), *ws[1:],
                       quant="w8")


# ---------------------------------------------------------------------------
# the slice as a whole: adaptive decode of the w8 view
# ---------------------------------------------------------------------------


def test_decode_dopri5_w8_matches_jax(toy_params):
    """Noise -> toy w8 U-ViT field (f32) -> dopri5 -> latents, port
    (``flow.decode``) against the JAX host loop on the JAX w8 field: the
    same step sequence, latents within 1e-4."""
    params, _, _ = toy_params
    z = np.random.default_rng(8).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    jm = JaxUViT(quant="w8", attn_impl="xla", **TOY)
    ref, rs = jsolvers.odeint_adaptive_host(
        lambda t, x: jm.apply(params, x, jnp.full((2,), t, jnp.float32))[0],
        jnp.asarray(z), 0.0, 1.0, return_stats=True, program="stages")
    m = load_uvit_from_jax(UViT(quant="w8", attn_impl="xla", device="cpu",
                                **TOY), params).eval()
    stats = {}
    sk = {"solver": "adaptive", "solver_adaptive": "dopri5",
          "controller": "i"}
    with torch.no_grad():
        out = tflow.decode(lambda t, x: m(x, t)[0], _t(z), sk, stats=stats)
    assert {k: stats[k] for k in rs} == rs and stats["t"] == 1.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_sample_lfm_w8_adaptive_on_cpu(tmp_path, capsys):
    """The entry point samples the w8 view with the config's adaptive
    solve on the CPU: f32 parameters, finite latents, each batch's NFE."""
    cfg = get_config("synthetic_smoke")
    model = sample_lfm.build_model(cfg, torch.device("cpu"), quant="w8")
    assert model.quant == "w8"
    assert all(p.dtype == torch.float32 for p in model.parameters())
    stats = []
    paths = sample_lfm.run("synthetic_smoke", n_samples=3, batch=2,
                           out=str(tmp_path), device="cpu", quant="w8",
                           solver="adaptive", stats=stats)
    arrays = [np.load(p) for p in paths]
    assert [a.shape for a in arrays] == [(2, 8, 8, 4), (1, 8, 8, 4)]
    assert all(np.isfinite(a).all() for a in arrays)
    assert len(stats) == 2 and all(s["t"] == 1.0 and s["nfe"] ==
                                   2 + 6 * s["steps"] for s in stats)
    sample_lfm.main(["--config", "synthetic_smoke", "--n_samples", "1",
                     "--batch", "1", "--quant", "w8", "--solver", "fixadp",
                     "--t_edit", "0.5", "--controller", "i", "--rtol",
                     "1e-4", "--atol", "1e-4", "--out",
                     str(tmp_path / "m"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "batch 0: NFE" in printed and "accepted" in printed
    assert (tmp_path / "m" / "0.npy").exists()
