"""The T2I family of the port held to the JAX package on the CPU:
``models.UViTT2I``, the CLIP text tower, ``AttnEdit`` / ``p2p_col_mult``
and the attention-editing helpers.

A toy U-ViT-T2I (embed 64, depth 2, 2 heads of 32, 4x4 latents, 6 context
tokens of 16: L = 1 + 6 + 4 = 11) is initialised in JAX and carried across
with ``load_uvit_t2i_from_jax`` (``strict=True``); both packages run the same
numpy inputs. Tolerances: f32 1e-5 max-abs on the velocity and 1e-4 on the
taps and probabilities (a dozen matmuls summed in another order); bf16 one
bf16 step of the largest output value; the W8A8 view the U-ViT field's int8
rule of ``tests/test_torch_quant.py`` (f32 max-abs 2e-2 and rel-L2 1e-3).
The CLIP tower in f32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.codecs.clip_text import CLIPTextEncoder as JaxCLIP
from uspace_tpu.editing import attention_edit as jae
from uspace_tpu.editing.specs import AttnEdit as JaxAttnEdit
from uspace_tpu.editing.specs import p2p_col_mult as jax_p2p
from uspace_tpu.models.uvit_t2i import UViTT2I as JaxUViTT2I
from uspace_tpu.utils import ptp_vis as jptp
from uspace_tpu_torch.codecs import clip_text
from uspace_tpu_torch.codecs.convert import (
    clip_flax_to_torch,
    load_clip_from_jax,
    load_uvit_t2i_from_jax,
    uvit_flax_to_torch,
)
from uspace_tpu_torch.editing import attention_edit as tae
from uspace_tpu_torch.editing.specs import AttnEdit, p2p_col_mult
from uspace_tpu_torch.models import UViTT2I, get_nnet
from uspace_tpu_torch.ops import attention as tattn
from uspace_tpu_torch.utils import ptp_vis

CFG = dict(img_size=4, patch_size=2, in_chans=4, embed_dim=64, depth=2,
           num_heads=2, clip_dim=16, num_clip_token=6)
L = 1 + 6 + 4
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CLIP_TOY = dict(vocab_size=50, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, max_length=7)


def _data(seed=0, t=0.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((3, 4, 4, 4)).astype(np.float32)
    c = r.standard_normal((3, 6, 16)).astype(np.float32)
    return x, np.full((3,), t, np.float32), c


@pytest.fixture(scope="module")
def params():
    x, t, c = _data()
    p = jax.jit(JaxUViTT2I(**CFG).init)(jax.random.PRNGKey(0), x, t, c)
    return jax.tree.map(np.asarray, p)


def _port(params, dtype=torch.float32, **kw):
    m = UViTT2I(dtype=dtype, device="cpu", **CFG, **kw)
    return load_uvit_t2i_from_jax(m, params).eval()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, atol, rel=None):
    a, b = _np(port), _np(ref)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    if rel is not None:
        assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)


def _step(v):
    """One bf16 step at the largest |v|."""
    return 2.0 ** (np.floor(np.log2(np.abs(_np(v)).max())) - 7)


def _japply(jm, params, x, t, c, attn_edit=None, **static):
    """``jm.apply`` jitted (the Pallas routes' interpret mode runs as one
    XLA program, not op by op); ``static`` are the tap arguments."""
    return jax.jit(lambda p, x_, t_, c_, e: jm.apply(
        p, x_, t_, c_, attn_edit=e, **static))(params, x, t, c, attn_edit)


def _cols(mult=(0.0, 2.0, 0.5), ids=((1, -1), (2, 3), (-1, -1))):
    return jax_p2p(3, L, jnp.asarray(ids, jnp.int32), list(mult))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uvit_t2i_matches_jax(params, dtype):
    """Velocity and the head / mid / tail taps, unedited."""
    x, t, c = _data()
    jv, jtaps = _japply(JaxUViTT2I(dtype=JDT[dtype], **CFG), params, x, t,
                        c, capture=("head", "mid", "tail"))
    with torch.no_grad():
        tv, ttaps = _port(params, dtype)(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c),
            capture=("head", "mid", "tail"))
    assert tv.dtype == dtype and tuple(tv.shape) == (3, 4, 4, 4)
    tol = 1e-5 if dtype == torch.float32 else _step(jv)
    _close(tv, jv, tol)
    assert set(ttaps) == set(jtaps)
    for k in jtaps:
        _close(ttaps[k], jtaps[k], 1e-4 if dtype == torch.float32
               else 2 * _step(jtaps[k]))


@pytest.mark.parametrize("block_ids", [None, (0, 2)])
@pytest.mark.parametrize("t", [0.3, 0.7])
def test_attn_edit_and_capture_match_jax(params, block_ids, t):
    """An AttnEdit gated at t_edit 0.5 (so t = 0.3 edits, t = 0.7 does
    not), over every block or blocks 0 and 2 (block 1, the mid block, left
    out: it still takes the unfused route), with the probabilities of
    blocks 1 and 2 captured."""
    x, tt, c = _data(1, t)
    cols = _cols()
    jv, jtaps = _japply(
        JaxUViTT2I(**CFG), params, x, tt, c, capture_attn=(1, 2),
        attn_edit=JaxAttnEdit(col_mult=cols, t_edit=0.5,
                              block_ids=block_ids))
    edit = AttnEdit(torch.from_numpy(np.array(cols)), 0.5, block_ids)
    with torch.no_grad():
        tv, ttaps = _port(params)(torch.from_numpy(x), torch.from_numpy(tt),
                                  torch.from_numpy(c), attn_edit=edit,
                                  capture_attn=(1, 2))
    _close(tv, jv, 1e-5)
    assert set(ttaps) == set(jtaps) == {"attn_1", "attn_2"}
    for k in jtaps:
        assert ttaps[k].dtype == torch.float32
        assert tuple(ttaps[k].shape) == (3, 2, L, L)
        _close(ttaps[k], jtaps[k], 1e-5)
    # the edit acts at t = 0.3 only
    with torch.no_grad():
        plain, _ = _port(params)(torch.from_numpy(x), torch.from_numpy(tt),
                                 torch.from_numpy(c))
    moved = float((tv - plain).abs().max())
    assert (moved > 1e-4) == (t < 0.5), moved


def test_edited_bf16_and_w8a8_views_match_jax(params):
    """An edited call in bf16 (one bf16 step) and in the W8A8 view on the
    LN-fused route: there an edit takes the plain qkv and proj on the float
    weights and the int8 MLP (the int8 rule), as in JAX."""
    x, t, c = _data(2)
    cols = _cols()
    for dtype, quant, impl in ((torch.bfloat16, False, "auto"),
                               (torch.float32, True, "pallas_lnmlp"),
                               (torch.float32, True, "auto")):
        jm = JaxUViTT2I(dtype=JDT[dtype], quant=quant, attn_impl=impl, **CFG)
        jedit = JaxAttnEdit(col_mult=cols, t_edit=1.0, block_ids=(1,))
        jv, _ = _japply(jm, params, x, t, c, attn_edit=jedit)
        jv0, _ = _japply(jm, params, x, t, c)
        m = _port(params, dtype, quant=quant, attn_impl=impl)
        edit = AttnEdit(torch.from_numpy(np.array(cols)), 1.0, (1,))
        with torch.no_grad():
            tv, _ = m(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(c), attn_edit=edit)
            tv0, _ = m(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(c))
        for mine, ref in ((tv, jv), (tv0, jv0)):
            if quant:
                _close(mine, ref, 2e-2, 1e-3)
            else:
                _close(mine, ref, 2 * _step(ref))


def test_multiplier_1_edit_is_the_plain_forward(params):
    """On the plain route an edit of multiplier 1 changes no bit (V times
    ones), in bf16; on the CPU both routes are the plain math."""
    x, t, c = _data(3)
    m = _port(params, torch.bfloat16, attn_impl="xla")
    cols = torch.from_numpy(np.array(_cols((1.0, 1.0, 1.0))))
    with torch.no_grad():
        ref, _ = m(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(c))
        out, _ = m(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(c), attn_edit=AttnEdit(cols))
    assert torch.equal(out, ref)


def test_remat_and_registry(params):
    """``get_nnet("uvit_t2i")`` builds it; with use_checkpoint the plain
    call is rematted (same values and gradients), an edited call is not."""
    m = get_nnet("uvit_t2i", device="cpu", use_checkpoint=True, **CFG)
    assert isinstance(m, UViTT2I) and all(m.remat)
    load_uvit_t2i_from_jax(m, params)
    ref = _port(params)
    x, t, c = (torch.from_numpy(a) for a in _data(4))
    outs = []
    for model in (m, ref):
        v, _ = model(x, t, c)
        g = torch.autograd.grad(v.square().sum(),
                                [model.context_embed.weight])[0]
        outs.append((v.detach(), g))
    _close(outs[0][0], outs[1][0], 1e-6)
    _close(outs[0][1], outs[1][1], 1e-5)
    assert set(uvit_flax_to_torch(params)) == set(m.state_dict())


# ---------------------------------------------------------------------------
# p2p multipliers and the attention-editing helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("time_tokens", [0, 1])
def test_p2p_col_mult_matches_jax(time_tokens):
    """Per-example multipliers, -1 padding (dropped, never column 0, which
    is a real target at time_tokens 0), an id past L dropped."""
    ids = np.array([[0, -1, 3], [-1, -1, -1], [4, 2, 20]], np.int32)
    for mult in ([0.0, 2.0, 0.5], 1.5):
        ref = jax_p2p(3, 8, jnp.asarray(ids), mult, time_tokens=time_tokens)
        out = p2p_col_mult(3, 8, ids, mult, time_tokens=time_tokens)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    out = p2p_col_mult(3, 8, ids, [0.0, 2.0, 0.5], time_tokens=0)
    assert out[0, 0] == 0.0 and out[1].eq(1.0).all()


def test_attn_edit_gate_and_blocks():
    cols = torch.full((2, 5), 3.0)
    e = AttnEdit(cols, t_edit=0.5, block_ids=(1,))
    assert e.effective_mult(0.3, 0) is None
    assert torch.equal(e.effective_mult(torch.tensor(0.5 + 5e-7), 1), cols)
    assert e.effective_mult(0.6, 1).eq(1.0).all()
    je = JaxAttnEdit(col_mult=jnp.asarray(cols.numpy()), t_edit=0.5)
    for t in (0.3, 0.5000005, 0.6):
        np.testing.assert_array_equal(
            AttnEdit(cols, 0.5).effective_mult(t, 3).numpy(),
            np.asarray(je.effective_mult(jnp.float32(t), 3)))


class _Tok:
    """A whitespace tokenizer with CLIP's start and end tokens."""

    def __init__(self):
        self.vocab = {}

    def encode(self, text):
        ids = [self.vocab.setdefault(w, len(self.vocab) + 2)
               for w in text.split(" ")]
        return [0] + ids + [1]

    def decode(self, ids):
        inv = {v: k for k, v in self.vocab.items()}
        return " ".join(inv.get(i, "") for i in ids)


def test_attention_edit_helpers_match_jax():
    caps = ["a red car on a road", "a dog", "red red house"]
    tok = _Tok()
    for phrase in ("red", "a dog", "ids:1,4", "ids:2"):
        np.testing.assert_array_equal(
            tae.phrase_target_ids(caps, phrase, tok, max_targets=4),
            jae.phrase_target_ids(caps, phrase, tok, max_targets=4))
    np.testing.assert_array_equal(
        clip_text.get_word_inds(caps[0], "red", tok),
        jae.get_word_inds(caps[0], "red", tok))
    for tk in (dict(token_dissect="lp_replace", lp_replace_from="red",
                    lp_replace_to="blue"),
               dict(token_dissect="lp_remove", lp_to_remove="red"),
               dict(token_dissect="lp_add", lp_to_add="at night"),
               dict(token_dissect=None)):
        assert tae.local_prompt_rewrite(caps, tk) == \
            jae.local_prompt_rewrite(caps, tk)
    ids = tae.phrase_target_ids(caps, "ids:1,2", None)
    e = tae.build_p2p_edit(3, L, ids, 0.0, t_edit=0.4, block_ids=(2,))
    je = jae.build_p2p_edit(3, L, ids, 0.0, t_edit=0.4, block_ids=(2,))
    np.testing.assert_array_equal(e.col_mult.numpy(),
                                  np.asarray(je.col_mult))
    assert (e.t_edit, e.block_ids) == (je.t_edit, je.block_ids)
    r = np.random.default_rng(0)
    probs = r.random((2, 3, 1 + 5 + 9, 1 + 5 + 9)).astype(np.float32)
    ctx = tae.slice_context_attention(torch.from_numpy(probs), 9, 5)
    jctx = jae.slice_context_attention(jnp.asarray(probs), 9, 5)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-6)
    np.testing.assert_allclose(
        tae.attention_heatmaps(ctx).numpy(),
        np.asarray(jae.attention_heatmaps(jctx)), atol=1e-6)


def test_attention_maps_and_ptp_pictures(tmp_path):
    """save_attention_maps writes one picture a caption, as JAX's does;
    the ptp helpers make JAX's canvases."""
    r = np.random.default_rng(1)
    ctx = r.random((2, 16, 5)).astype(np.float32)
    tae.save_attention_maps(ctx, str(tmp_path / "t"), ["a b", "c"],
                            timestep=0.5, block_id=3)
    jae.save_attention_maps(ctx, str(tmp_path / "j"), ["a b", "c"],
                            timestep=0.5, block_id=3)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir()) == [
        "a_b_block3_time0.50.png", "c_block3_time0.50.png"]
    imgs = r.integers(0, 255, (3, 8, 10, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ptp_vis.view_images(imgs, num_rows=2),
                                  jptp.view_images(imgs, num_rows=2))
    np.testing.assert_array_equal(ptp_vis.text_under_image(imgs[0], "hi"),
                                  jptp.text_under_image(imgs[0], "hi"))


# ---------------------------------------------------------------------------
# the CLIP text tower
# ---------------------------------------------------------------------------


def test_clip_text_encoder_matches_jax_and_is_causal():
    r = np.random.default_rng(5)
    ids = r.integers(0, 50, (2, 7))
    p = jax.jit(JaxCLIP(**CLIP_TOY).init)(jax.random.PRNGKey(1),
                                          jnp.asarray(ids))
    p = jax.tree.map(np.asarray, p)
    ref = jax.jit(JaxCLIP(**CLIP_TOY).apply)(p, jnp.asarray(ids))
    m = load_clip_from_jax(clip_text.CLIPTextEncoder(**CLIP_TOY,
                                                     device="cpu"), p)
    assert set(clip_flax_to_torch(p)) == set(m.state_dict())
    with torch.no_grad():
        out = m(torch.from_numpy(ids))
        ids2 = ids.copy()
        ids2[:, 4:] = (ids2[:, 4:] + 7) % 50
        out2 = m(torch.from_numpy(ids2))
    _close(out, ref, 1e-5)
    # causal: positions before the change do not move, later ones do
    assert torch.equal(out[:, :4], out2[:, :4])
    assert float((out[:, 4:] - out2[:, 4:]).abs().max()) > 1e-3
    np.testing.assert_allclose(clip_text.quick_gelu(torch.linspace(-3, 3, 7))
                               .numpy(), np.asarray(
        jax.nn.sigmoid(1.702 * jnp.linspace(-3, 3, 7))
        * jnp.linspace(-3, 3, 7)), atol=1e-6)


def test_clip_embedder_refuses_without_tokenizer():
    enc = clip_text.build_clip(CLIP_TOY, device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer"):
        clip_text.FrozenCLIPEmbedder(enc, None)
    assert clip_text.CLIP_L14 == dict(vocab_size=49408, hidden_size=768,
                                      intermediate_size=3072, num_layers=12,
                                      num_heads=12, max_length=77)


def test_edit_and_capture_launch_nothing_on_the_cpu():
    """The edited call goes through the plain attention (no kernel wrapper
    is even called)."""
    tattn.reset_launches()
    m = UViTT2I(device="cpu", **CFG).init_weights(
        torch.Generator().manual_seed(0))
    x, t, c = (torch.from_numpy(a) for a in _data(6))
    with torch.no_grad():
        m(x, t, c, attn_edit=AttnEdit(torch.ones(3, L)), capture_attn=(0,))
    assert not any(tattn.LAUNCHES.values())
