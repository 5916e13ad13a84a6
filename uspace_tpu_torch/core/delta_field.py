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
the time embedding) is recomputed per stage; in the ``"grad"`` hidden
mode the GELU difference is linearised, ``dg = de * gelu'(e_b)`` (its
O(h^2) remainder is smooth). The wide caches (qkv and gelu'(e)) are int8
with row scales, and the base consumes the dequantized qkv itself, so a
delta evaluation at the base's own point reproduces the base bit for bit.

``fused=True`` runs the kernels of :mod:`uspace_tpu_torch.ops.delta`;
``fused=False`` is the plain composition with the same anchoring (the
unfused base codes gelu'(e) with one scale per whole row, the fused one
per row and strip, as in JAX; each path reads only its own caches). The
eager parts stay eager, as XLA computes them outside any Pallas kernel:
the base's proj, skip_linear in base and delta (``ops.quant`` int8
products), embed and decoder.

The functions read the model's float weights, whatever its ``quant``
view, through :func:`prepare_delta_params`, run once outside the solve.
Only ``hidden_mode="grad"`` (the default) is ported; ``"exact"`` and
``"gelu"`` need kernels 20, 21, 24 and 25 of the kernel table.
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

DEFAULT_HIDDEN_MODE = "grad"
HIDDEN_MODES = ("exact", "gelu", "grad")
_UNPORTED_MODES = {
    "exact": "hidden_mode='exact' needs kernels 20 and 25 of the kernel table "
             "(_base_mlp_cache_kernel, _delta_mlp_kernel), not ported yet",
    "gelu": "hidden_mode='gelu' needs kernels 21 and 24 of the kernel table "
            "(_base_mlp_cache_kernel_g, _delta_mlp_kernel_g), not ported yet",
}


def check_hidden_mode(hidden_mode: str) -> None:
    """A typo raises ValueError and the modes of the next slice raise
    NotImplementedError, on both paths, before any compute."""
    if hidden_mode not in HIDDEN_MODES:
        raise ValueError(f"hidden_mode={hidden_mode!r} (expected "
                         f"exact|gelu|grad)")
    if hidden_mode in _UNPORTED_MODES:
        raise NotImplementedError(_UNPORTED_MODES[hidden_mode])


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


def _fc2_affine_exact(g2: torch.Tensor, qw2: QWeight) -> torch.Tensor:
    """fc2 on the affine-strip codes of the GELU output, quantize-then-use:
    the exact int8 product per strip, ``sum_n f32(d_n) * g_s[:, n] + g_z @
    colsum`` (the zero points' column-sum term), times the column scales."""
    g_q, g_s, g_z = _affine_strips(g2, _n_strips(g2.shape[-1]))
    n = g_s.shape[-1]
    hs = g2.shape[-1] // n
    w2 = qw2.kn.reshape(n, hs, -1)
    dd = torch.stack([int_matmul(g_q[:, j * hs:(j + 1) * hs], w2[j])
                      for j in range(n)]).float()
    colsum = w2.to(torch.int32).sum(dim=1).float()
    acc = torch.einsum("nrc,rn->rc", dd, g_s) + g_z @ colsum
    return acc * qw2.scale


def _skip_base(bp: Dict, h: torch.Tensor, skip: torch.Tensor,
               dtype) -> torch.Tensor:
    cin = torch.cat([h, skip], dim=-1)
    return (_int8_dot(cin.float(), bp["skip"]) + bp["skipb"]).to(dtype)


def anchored_vf_base(model, dp: Dict, t, x: torch.Tensor, fused: bool = True,
                     hidden_mode: str = DEFAULT_HIDDEN_MODE
                     ) -> Tuple[torch.Tensor, Dict]:
    """Full int8 evaluation emitting the read-only anchored cache: per block
    ``qkv_q``/``qkv_s`` (the fused cache padded to Lp rows), ``a``, ``xm``,
    ``gp_q``/``gp_s`` (gelu'(e) codes), ``m``, ``o`` (the block output
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
            h, c["gp_q"], c["gp_s"], c["m"] = delta_ops.base_mlp_block(
                xm, bp["n2s"], bp["n2b"], bp["fc1"].kn, bp["fc1"].scale,
                bp["fc1b"], bp["fc2"].kn, bp["fc2"].scale, bp["fc2b"],
                LN_EPS, mode="grad")
        else:
            e = _int8_dot(_ln_f32(xm, bp["n2s"], bp["n2b"], LN_EPS),
                          bp["fc1"]) + bp["fc1b"]
            # the base consumes the exact hidden; only gelu'(e) is cached,
            # coded per whole row
            hid = e.shape[-1]
            c["gp_q"], c["gp_s"] = quantize_rowwise(
                gelu_grad(e).reshape(-1, hid))
            acc = _fc2_affine_exact(_gelu_f32(e).reshape(-1, hid), bp["fc2"])
            m = (acc + bp["fc2b"]).to(dtype).reshape(xm.shape)
            c["m"] = m
            h = xm + m
        c["o"] = h
        if bi < half:
            skips.append(h)
        cache[name] = c
    v = _decode_out(model, dp["_plain"], h, dtype)
    return v.float(), cache


def anchored_vf_delta(model, dp: Dict, t, x: torch.Tensor, cache: Dict,
                      fused: bool = True) -> torch.Tensor:
    """Delta evaluation anchored at the base cache: every projection =
    cached + int8(stage delta); LN, attention and residuals recomputed
    exactly, the GELU linearised at the base (``"grad"``). Emits
    nothing."""
    dtype = model.dtype
    heads = model.mid_block.attn.num_heads
    half = model.depth // 2
    h = _embed(model, dp["_plain"], x, t, dtype)
    hb = cache["_h0"]
    skips, skips_b = [], []
    for bi, name in enumerate(_block_names(model.depth)):
        bp = dp[name]
        cb = cache[name]
        if "gp_q" not in cb:
            check_hidden_mode("gelu" if "g_q" in cb else "exact")
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
            o = delta_ops.delta_mlp_block(
                xm, cb["xm"], cb["gp_q"], cb["gp_s"], cb["m"], bp["n2s"],
                bp["n2b"], bp["fc1"].kn, bp["fc1"].scale, bp["fc2"].kn,
                bp["fc2"].scale, LN_EPS, grad=True)
        else:
            u = _ln_f32(h, bp["n1s"], bp["n1b"], LN_EPS)
            u_b = _ln_f32(hb, bp["n1s"], bp["n1b"], LN_EPS)
            qkv = cb["qkv_q"].float() * cb["qkv_s"] \
                + _int8_dot(u - u_b, bp["qkv"])
            a = fused_qkv_attention(qkv.to(dtype), heads)
            da = a.float() - cb["a"].float()
            xm = (h.float() - hb.float() + cb["xm"].float()
                  + _int8_dot(da, bp["proj"])).to(dtype)
            u2 = _ln_f32(xm, bp["n2s"], bp["n2b"], LN_EPS)
            u2_b = _ln_f32(cb["xm"], bp["n2s"], bp["n2b"], LN_EPS)
            de = _int8_dot(u2 - u2_b, bp["fc1"])
            gp = (cb["gp_q"].float() * cb["gp_s"]).reshape(de.shape)
            m = cb["m"].float() + _int8_dot(de * gp, bp["fc2"])
            o = xm + m.to(dtype)
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
