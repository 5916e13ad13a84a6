"""Base-anchored stage-delta int8 velocity field for adaptive solvers
(U-ViT family); counterpart of ``uspace_tpu/core/delta_field.py``.

Why: a plain W8A8 field codes every activation afresh at every RK stage;
that rounding noise has a fixed floor which the dopri5 error estimate
picks up, and NFE grows (the port's W8A8 dopri5 control needs about twice
the bf16 NFE). Here stage 2 of each step (the first fresh evaluation)
runs the field once in full int8 ("base") and keeps each block's
projection inputs and outputs as a read-only cache; stages 3..7 ("delta")
rebuild every projection (qkv, proj, skip, fc1, fc2) as

    out_i = out_base + W_int8 @ q8(in_i - in_base)

an int8 product whose rounding step shrinks with the stage gap, while the
base's own rounding is shared by every stage of the step and cancels in
the error estimate. Everything nonlinear (LayerNorm, softmax, residuals,
the time embedding) is recomputed per stage. The MLP hidden's cache is
the ``hidden_mode``'s: ``"exact"`` keeps the pre-GELU hidden ``e`` as int8
codes and the delta recomputes both GELUs, ``dg = gelu(e_b + de) -
gelu(e_b)``; ``"gelu"`` also keeps the affine codes of the GELU output that
fc2 read, and the delta anchors there, ``dg = gelu(e_b + de) - g_b`` (one
GELU); ``"grad"`` keeps gelu'(e) instead and linearises, ``dg = de *
gelu'(e_b)`` (its O(h^2) remainder is smooth; no GELU). The wide caches
(qkv and the hidden) are int8 with row scales, and the base consumes the
dequantized qkv and ``e`` itself, so a delta evaluation at the base's own
point reproduces the base bit for bit (in ``"gelu"`` mode it re-rounds the
base's hidden residual, within 5e-3).

``fused=True`` runs the kernels of :mod:`uspace_tpu_torch.ops.delta`;
``fused=False`` is the plain composition with the same anchoring, and the
JAX package's own layout and rounding: the unfused base codes ``e`` and
gelu'(e) with ``quantize_rowwise`` (a division, clipped) and one scale per
whole row, the fused one with the kernels' product per row and strip; the
unfused ``"exact"`` fc2 codes GELU's output per whole row, the fused one on
the affine strips. Each path reads only its own caches. The eager parts
stay eager, as XLA computes them outside any Pallas kernel: the base's
proj, skip_linear in base and delta (``ops.quant`` int8 products), embed
and decoder.

The functions read the model's float weights, whatever its ``quant``
view, through :func:`prepare_delta_params`, run once outside the solve.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import LN_EPS, patchify, timestep_embedding, unpatchify
from ..ops import delta as delta_ops
from ..ops.attention import _ln_f32, fused_qkv_attention
from ..ops.mlp import _gelu_f32, col_slices, gelu_grad
from ..ops.quant import (QWeight, int8_matmul, int_matmul, quantize_rowwise,
                         quantized_weight)

DEFAULT_HIDDEN_MODE = "grad"  # make_delta_field's, as in the JAX package
HIDDEN_MODES = ("exact", "gelu", "grad")
# the fused base MLP kernel of each hidden mode (ops.delta.base_mlp_block)
_BASE_MLP_MODE = {"exact": "e", "gelu": "e+g", "grad": "grad"}


def check_hidden_mode(hidden_mode: str) -> None:
    """A typo raises ValueError on both paths, before any compute."""
    if hidden_mode not in HIDDEN_MODES:
        raise ValueError(f"hidden_mode={hidden_mode!r} (expected "
                         f"exact|gelu|grad)")


def check_model(model) -> None:
    """The field mirrors the bare U-ViT forward (``[time, patches]`` tokens,
    no label token, no time MLP, no qkv bias, the final conv): refuse any
    other model rather than evaluate a different field."""
    from ..models.uvit import UViT

    if not isinstance(model, UViT):
        raise NotImplementedError(
            "stage_delta_int8 is built for the UViT family (the "
            "core/delta_field.py block layout)")
    if model.label_emb is not None:
        raise NotImplementedError(
            "stage_delta_int8 sampling is uncond-only: the delta field "
            "evaluates the bare U-ViT, with no label token")
    if not isinstance(model.time_embed, torch.nn.Identity):
        raise NotImplementedError(
            "stage_delta_int8 reads the sinusoidal time token directly; a "
            "U-ViT with mlp_time_embed is not supported")
    if model.mid_block.qkv_bias:
        raise NotImplementedError(
            "stage_delta_int8 has no qkv bias term (the U-ViT configs have "
            "qkv_bias=False)")
    if model.final_layer is None:
        raise NotImplementedError("stage_delta_int8 needs the final 3x3 conv")


def _int8_dot(xf: torch.Tensor, qw: QWeight) -> torch.Tensor:
    """Row-quantize x (``quantize_rowwise``: a division by the rounded
    scale, clipped) and one int8 product; f32 out."""
    xq, xs = quantize_rowwise(xf)
    return int8_matmul(xq, xs, qw.kn, qw.scale)


def _vec(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).reshape(-1).contiguous()


@torch.no_grad()
def prepare_delta_params(model) -> Dict[str, Any]:
    """Quantize every block projection once (``quantize_colwise`` of the
    float weight in the JAX layout, kept as the kernels' ``QWeight``) and
    cast the embed and decoder weights to the compute dtype once. Run it
    outside the solve; the field functions read only its result."""
    check_model(model)
    dt = model.dtype
    pe = model.patch_embed.proj
    e = pe.weight.shape[0]
    plain = {
        # the strided patch conv as patchify @ the HWIO-flattened kernel
        "patch_w": pe.weight.detach().permute(2, 3, 1, 0).reshape(-1, e)
        .to(dt).contiguous(),
        "patch_b": pe.bias.detach().to(dt),
        "pos_embed": model.pos_embed.detach().to(dt),
        "norm_s": _vec(model.norm.weight), "norm_b": _vec(model.norm.bias),
        "dec_w": model.decoder_pred.weight.detach().t().to(dt).contiguous(),
        "dec_b": model.decoder_pred.bias.detach().to(dt),
        "final_w": model.final_layer.weight.detach().to(dt),
        "final_b": model.final_layer.bias.detach().to(dt),
    }
    out: Dict[str, Any] = {"_plain": plain}

    def quant(dense) -> QWeight:
        return quantized_weight(dense.weight.detach().float().t())

    blocks = ([(f"in_blocks_{i}", b) for i, b in enumerate(model.in_blocks)]
              + [("mid_block", model.mid_block)]
              + [(f"out_blocks_{i}", b)
                 for i, b in enumerate(model.out_blocks)])
    for name, blk in blocks:
        b = {
            "n1s": _vec(blk.norm1.weight), "n1b": _vec(blk.norm1.bias),
            "n2s": _vec(blk.norm2.weight), "n2b": _vec(blk.norm2.bias),
            "qkv": quant(blk.attn.qkv),
            "proj": quant(blk.attn.proj), "projb": _vec(blk.attn.proj.bias),
            "fc1": quant(blk.mlp.fc1), "fc1b": _vec(blk.mlp.fc1.bias),
            "fc2": quant(blk.mlp.fc2), "fc2b": _vec(blk.mlp.fc2.bias),
        }
        if blk.skip_linear is not None:
            b["skip"] = quant(blk.skip_linear)
            b["skipb"] = _vec(blk.skip_linear.bias)
        out[name] = b
    return out


def _block_names(depth: int):
    half = depth // 2
    return ([f"in_blocks_{i}" for i in range(half)] + ["mid_block"]
            + [f"out_blocks_{i}" for i in range(half)])


def _embed(model, plain: Dict, x: torch.Tensor, t, dtype) -> torch.Tensor:
    """Patch embed + time token + pos embed (exact, recomputed per stage):
    ``patchify(x) @ W`` in the compute dtype, then the bias added in it."""
    tok = patchify(x.to(dtype), model.patch_size) @ plain["patch_w"] \
        + plain["patch_b"]
    b = x.shape[0]
    t_emb = timestep_embedding(
        torch.full((b,), float(t), dtype=torch.float32, device=x.device),
        model.embed_dim).to(dtype)
    h = torch.cat([t_emb[:, None, :], tok], dim=1)
    return h + plain["pos_embed"]


def _decode_out(model, plain: Dict, h: torch.Tensor, dtype) -> torch.Tensor:
    """f32 final LN rounded to the compute dtype, the decoder, unpatchify,
    the 3x3 conv (its bias added after it, in the compute dtype)."""
    hf = _ln_f32(h, plain["norm_s"], plain["norm_b"], LN_EPS).to(dtype)
    hf = (hf @ plain["dec_w"] + plain["dec_b"])[:, 1:, :]
    img = unpatchify(hf, model.in_chans)
    img = F.conv2d(img.permute(0, 3, 1, 2), plain["final_w"], padding=1)
    return img.permute(0, 2, 3, 1) + plain["final_b"]


def _affine_strips(g: torch.Tensor, n_slices: int):
    """Per-row per-strip asymmetric-affine int8 codes of the post-GELU
    hidden (the plain twin of the fused base's fc2 input)."""
    r, h = g.shape
    gs = g.reshape(r, n_slices, h // n_slices)
    gmax = gs.amax(dim=-1, keepdim=True)
    gmin = gs.amin(dim=-1, keepdim=True)
    sc = torch.clamp(gmax - gmin, min=1e-8) * (1.0 / 254.0)
    zp = (gmax + gmin) * 0.5
    gq = torch.round((gs - zp) / sc).to(torch.int8)
    return gq.reshape(r, h), sc[..., 0], zp[..., 0]


# strip count of the affine hidden codes: the fused kernels' rule (the
# largest count <= ops.mlp.COL_SLICES that divides the hidden width), so the
# fused and unfused affine caches keep one layout at every model size
_n_strips = col_slices


def _affine_deq(g_q: torch.Tensor, g_s: torch.Tensor,
                g_z: torch.Tensor) -> torch.Tensor:
    """``f32(g_q) * g_s + g_z`` per row and strip, [rows, hidden]."""
    r, h = g_q.shape
    n = g_s.shape[-1]
    gs = g_q.reshape(r, n, h // n).float()
    return (gs * g_s[..., None] + g_z[..., None]).reshape(r, h)


def _fc2_affine_exact(g2: torch.Tensor, qw2: QWeight):
    """fc2 on the affine-strip codes of the GELU output, quantize-then-use:
    the exact int8 product per strip, ``sum_n f32(d_n) * g_s[:, n] + g_z @
    colsum`` (the zero points' column-sum term), times the column scales.
    Returns it with the ``(g_q, g_s, g_z)`` cache."""
    g_q, g_s, g_z = _affine_strips(g2, _n_strips(g2.shape[-1]))
    n = g_s.shape[-1]
    hs = g2.shape[-1] // n
    w2 = qw2.kn.reshape(n, hs, -1)
    dd = torch.stack([int_matmul(g_q[:, j * hs:(j + 1) * hs], w2[j])
                      for j in range(n)]).float()
    colsum = w2.to(torch.int32).sum(dim=1).float()
    acc = torch.einsum("nrc,rn->rc", dd, g_s) + g_z @ colsum
    return acc * qw2.scale, (g_q, g_s, g_z)


def _mlp_base_unfused(bp: Dict, xm: torch.Tensor, hidden_mode: str,
                      c: Dict, dtype) -> torch.Tensor:
    """The unfused base MLP half (``uspace_tpu/core/delta_field.py``'s
    layout): writes the mode's cache into ``c``, returns ``m``."""
    e = _int8_dot(_ln_f32(xm, bp["n2s"], bp["n2b"], LN_EPS),
                  bp["fc1"]) + bp["fc1b"]
    hid = e.shape[-1]
    if hidden_mode == "grad":
        # the base consumes the exact hidden; only gelu'(e) is cached, coded
        # per whole row
        c["gp_q"], c["gp_s"] = quantize_rowwise(gelu_grad(e).reshape(-1, hid))
        g = _gelu_f32(e)
    else:
        # e coded per whole row (a division, clipped), consumed as coded
        c["e_q"], c["e_s"] = quantize_rowwise(e)
        g = _gelu_f32(c["e_q"].float() * c["e_s"])
    if hidden_mode == "exact":
        return (_int8_dot(g, bp["fc2"]) + bp["fc2b"]).to(dtype)
    acc, gcache = _fc2_affine_exact(g.reshape(-1, hid), bp["fc2"])
    if hidden_mode == "gelu":
        c["g_q"], c["g_s"], c["g_z"] = gcache
    return (acc + bp["fc2b"]).to(dtype).reshape(xm.shape)


def _mlp_delta_unfused(bp: Dict, xm: torch.Tensor, cb: Dict,
                       dtype) -> torch.Tensor:
    """The unfused delta MLP half on the unfused base's cache: the hidden
    mode read from its keys."""
    u2 = _ln_f32(xm, bp["n2s"], bp["n2b"], LN_EPS)
    u2_b = _ln_f32(cb["xm"], bp["n2s"], bp["n2b"], LN_EPS)
    de = _int8_dot(u2 - u2_b, bp["fc1"])
    if "gp_q" in cb:
        dg = de * (cb["gp_q"].float() * cb["gp_s"]).reshape(de.shape)
    else:
        e_b = cb["e_q"].float() * cb["e_s"]
        if "g_q" in cb:
            g_b = _affine_deq(cb["g_q"], cb["g_s"], cb["g_z"]).reshape(
                e_b.shape)
        else:
            g_b = _gelu_f32(e_b)
        dg = _gelu_f32(e_b + de) - g_b
    m = cb["m"].float() + _int8_dot(dg, bp["fc2"])
    return xm + m.to(dtype)


def _skip_base(bp: Dict, h: torch.Tensor, skip: torch.Tensor,
               dtype) -> torch.Tensor:
    cin = torch.cat([h, skip], dim=-1)
    return (_int8_dot(cin.float(), bp["skip"]) + bp["skipb"]).to(dtype)


def anchored_vf_base(model, dp: Dict, t, x: torch.Tensor, fused: bool = True,
                     hidden_mode: str = "exact"
                     ) -> Tuple[torch.Tensor, Dict]:
    """Full int8 evaluation emitting the read-only anchored cache: per block
    ``qkv_q``/``qkv_s`` (the fused cache padded to Lp rows), ``a``, ``xm``,
    the MLP hidden's cache of ``hidden_mode`` (the JAX function's default
    ``"exact"``: ``e_q``/``e_s``; ``"gelu"``: those and ``g_q``/``g_s``/
    ``g_z``; ``"grad"``: ``gp_q``/``gp_s``), ``m``, ``o`` (the block output
    itself, no copy) and, for skip blocks, ``xpost``; ``_h0`` is the
    post-embed stream. Returns ``(v f32, cache)``."""
    check_hidden_mode(hidden_mode)
    dtype = model.dtype
    heads = model.mid_block.attn.num_heads
    half = model.depth // 2
    h = _embed(model, dp["_plain"], x, t, dtype)
    cache: Dict[str, Any] = {"_h0": h}
    skips = []
    for bi, name in enumerate(_block_names(model.depth)):
        bp = dp[name]
        c: Dict[str, torch.Tensor] = {}
        if "skip" in bp:
            h = _skip_base(bp, h, skips.pop(), dtype)
            c["xpost"] = h
        if fused:
            a, c["qkv_q"], c["qkv_s"] = delta_ops.base_attn_block(
                h, bp["n1s"], bp["n1b"], bp["qkv"].kn, bp["qkv"].scale,
                heads, LN_EPS)
        else:
            qkv = _int8_dot(_ln_f32(h, bp["n1s"], bp["n1b"], LN_EPS),
                            bp["qkv"])
            c["qkv_q"], c["qkv_s"] = quantize_rowwise(qkv)
            a = fused_qkv_attention(
                (c["qkv_q"].float() * c["qkv_s"]).to(dtype), heads)
        c["a"] = a
        p = _int8_dot(a.float(), bp["proj"]) + bp["projb"]
        xm = (h.float() + p).to(dtype)
        c["xm"] = xm
        if fused:
            out = delta_ops.base_mlp_block(
                xm, bp["n2s"], bp["n2b"], bp["fc1"].kn, bp["fc1"].scale,
                bp["fc1b"], bp["fc2"].kn, bp["fc2"].scale, bp["fc2b"],
                LN_EPS, mode=_BASE_MLP_MODE[hidden_mode])
            h, c["m"] = out[0], out[3]
            keys = (("gp_q", "gp_s") if hidden_mode == "grad" else
                    ("e_q", "e_s", "g_q", "g_s", "g_z"))
            c.update(zip(keys, out[1:3] + out[4:]))
        else:
            c["m"] = _mlp_base_unfused(bp, xm, hidden_mode, c, dtype)
            h = xm + c["m"]
        c["o"] = h
        if bi < half:
            skips.append(h)
        cache[name] = c
    v = _decode_out(model, dp["_plain"], h, dtype)
    return v.float(), cache


def anchored_vf_delta(model, dp: Dict, t, x: torch.Tensor, cache: Dict,
                      fused: bool = True) -> torch.Tensor:
    """Delta evaluation anchored at the base cache: every projection =
    cached + int8(stage delta); LN, attention, GELU and residuals recomputed
    exactly (the GELU linearised at the base in ``"grad"`` mode). The hidden
    mode is read from the cache's keys, as in JAX. Emits nothing."""
    dtype = model.dtype
    heads = model.mid_block.attn.num_heads
    half = model.depth // 2
    h = _embed(model, dp["_plain"], x, t, dtype)
    hb = cache["_h0"]
    skips, skips_b = [], []
    for bi, name in enumerate(_block_names(model.depth)):
        bp = dp[name]
        cb = cache[name]
        if "skip" in bp:
            cin = torch.cat([h, skips.pop()], dim=-1)
            cin_b = torch.cat([hb, skips_b.pop()], dim=-1)
            d = cin.float() - cin_b.float()
            h = (cb["xpost"].float() + _int8_dot(d, bp["skip"])).to(dtype)
            hb = cb["xpost"]
        if fused:
            xm = delta_ops.delta_attn_block(
                h, hb, cb["qkv_q"], cb["qkv_s"], cb["a"], cb["xm"],
                bp["n1s"], bp["n1b"], bp["qkv"].kn, bp["qkv"].scale,
                bp["proj"].kn, bp["proj"].scale, heads, LN_EPS)
            grad = "gp_q" in cb
            o = delta_ops.delta_mlp_block(
                xm, cb["xm"], cb["gp_q"] if grad else cb["e_q"],
                cb["gp_s"] if grad else cb["e_s"], cb["m"], bp["n2s"],
                bp["n2b"], bp["fc1"].kn, bp["fc1"].scale, bp["fc2"].kn,
                bp["fc2"].scale, LN_EPS,
                gelu_cache=((cb["g_q"], cb["g_s"], cb["g_z"])
                            if "g_q" in cb else None),
                grad=grad)
        else:
            u = _ln_f32(h, bp["n1s"], bp["n1b"], LN_EPS)
            u_b = _ln_f32(hb, bp["n1s"], bp["n1b"], LN_EPS)
            qkv = cb["qkv_q"].float() * cb["qkv_s"] \
                + _int8_dot(u - u_b, bp["qkv"])
            a = fused_qkv_attention(qkv.to(dtype), heads)
            da = a.float() - cb["a"].float()
            xm = (h.float() - hb.float() + cb["xm"].float()
                  + _int8_dot(da, bp["proj"])).to(dtype)
            o = _mlp_delta_unfused(bp, xm, cb, dtype)
        h = o
        hb = cb["o"]
        if bi < half:
            skips.append(h)
            skips_b.append(hb)
    v = _decode_out(model, dp["_plain"], h, dtype)
    return v.float()


def make_delta_field(model, dp: Dict, fused: bool = True,
                     hidden_mode: str = None):
    """``(vf_base(t, x) -> (f, cache), vf_delta(t, x, cache) -> f)`` for
    the ``stage_delta`` option of :func:`core.solvers.odeint_adaptive`
    (``dp`` from :func:`prepare_delta_params`). The delta side reads the
    hidden mode from the cache's keys."""
    if hidden_mode is None:
        hidden_mode = DEFAULT_HIDDEN_MODE
    check_hidden_mode(hidden_mode)
    return (lambda t, x: anchored_vf_base(model, dp, t, x, fused=fused,
                                          hidden_mode=hidden_mode),
            lambda t, x, cache: anchored_vf_delta(model, dp, t, x, cache,
                                                  fused=fused))
