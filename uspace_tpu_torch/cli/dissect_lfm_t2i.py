"""T2I attention-editing CLI: prompt-to-prompt and local-prompt editing.

Counterpart of ``uspace_tpu/cli/dissect_lfm_t2i.py`` (the reference's
``dissect_lfm_t2i.py``). Modes (``--dissect_name``):

- ``p2p``: invert a batch of the dataset with its contexts, then decode the
  same z while rescaling the attention columns of the target context tokens
  (``--p2p_to_multiply``, ``--p2p_multiplier``, ``--target_block_id``);
- ``local_prompt``: invert with the original captions, decode with the
  rewritten captions' contexts (lp_replace / lp_remove / lp_add);
- ``sampled_image_editing``: decode shared noise under each p2p multiplier
  of a sweep;
- ``vis_attention``: per-token heatmaps of the image queries' attention to
  the context tokens, from the captured probabilities at t = 0.1, 0.5, 0.9.

Writes ``{i}_before.png`` / ``{i}_after.png`` / ``{i}_caption.txt``,
``sampled_editing_sweep.png`` with ``captions.txt``, or the heatmaps.

The CLIP tokenizer's vocabulary and the CLIP weights are not in the
repository, so a flow that needs them refuses where the JAX CLI does:
``local_prompt`` (it re-encodes captions through CLIP) and a free-form
phrase for p2p. ``--p2p_to_multiply ids:1,4`` names the context-token
indices themselves and needs no tokenizer, which is how the synthetic T2I
toys are edited. The joint-attention modes (p2p, sweeps with a phrase,
vis_attention) need ``uvit_t2i``: the SD-UNet conditions by
cross-attention and has no single [time, context, patches] token axis.
Runs on the card unless ``--device cpu``.

    python -m uspace_tpu_torch.cli.dissect_lfm_t2i --config synthetic_t2i_e2e \\
        --dissect_name p2p --p2p_to_multiply ids:1 --p2p_multiplier 0 \\
        --ckpt_path_to_dissect t2i_toy/ckpts --workdir p2p_out
    python -m uspace_tpu_torch.cli.dissect_lfm_t2i --config synthetic_t2i_e2e \\
        --dissect_name sampled_image_editing --p2p_to_multiply ids:1 \\
        --p2p_multiplier 0,1,2 --device cpu --workdir /tmp/sweep
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..data.datasets import get_dataset
from ..data.loader import DataLoader
from ..editing.attention_edit import (
    build_p2p_edit,
    local_prompt_rewrite,
    phrase_target_ids,
    save_attention_maps,
    slice_context_attention,
)
from ..train.step import make_velocity_fn, sample_from_moments
from ..utils.vis import make_grid, save_image
from .dissect_common import build_session, decode_images


def get_clip(config: dict):
    """(embedder, tokenizer) where the CLIP weights and tokenizer files
    exist, else (None, None). They are not in the repository, so a
    ``clip.pretrained_path`` that names them is refused for now."""
    path = (config.get("clip") or {}).get("pretrained_path", "")
    if path and os.path.exists(path):
        raise NotImplementedError(
            "loading CLIP weights and the tokenizer from "
            f"{path!r} waits until they are in the repository")
    return None, None


def _joint_attn_seq_len(config: dict, name: str) -> int:
    """The token count of the joint-attention layout [time, context,
    patches]: U-ViT-T2I only."""
    nnet = config["nnet"]
    if nnet["name"] != "uvit_t2i":
        raise NotImplementedError(
            f"{name}: joint-attention token editing applies to uvit_t2i "
            f"(got nnet.name={nnet['name']!r})")
    return 1 + nnet["num_clip_token"] + (
        nnet["img_size"] // nnet["patch_size"]) ** 2


def _split(dataset):
    return dataset.get_split("test" if getattr(dataset, "test", None)
                             is not None else "train")


def _latents(session, x: torch.Tensor, gen: torch.Generator):
    return (session.vae_sample(x, gen) if session.vae_sample is not None
            else sample_from_moments(x, gen))


def real_image_editing(cfg: dict, session, vae_decode, workdir: str,
                       gen: torch.Generator, clip=None,
                       tokenizer=None) -> str:
    """p2p / local_prompt on a batch of the dataset (the reference's
    ``dissect_lfm_t2i.py:137-260``)."""
    d = cfg["dissection"]
    tk = dict(d["token_kwargs"])
    name = d["dissect_name"]
    dev = session.device
    batch = next(iter(DataLoader(_split(get_dataset(**cfg["dataset"])),
                                 d["mini_batch_size"], shuffle=False)))
    n = len(batch["x"])
    captions = batch.get("caption", [""] * n)
    ctx = torch.as_tensor(np.asarray(batch["context"]), device=dev)
    x = _latents(session, torch.as_tensor(np.asarray(batch["x"]),
                                          device=dev), gen)
    # exact inversion with the original contexts (no edit while encoding)
    z = session.encode(x, {"context": ctx})
    if name == "local_prompt":
        if clip is None:
            raise RuntimeError("local_prompt needs CLIP weights "
                               "(config clip.pretrained_path)")
        new_caps = local_prompt_rewrite(captions, tk)
        edited = session.decode(z, {"context": clip.encode(new_caps)},
                                t_edit=float(d["t_edit"]))
        out_caps = new_caps
    elif name == "p2p":
        seq_len = _joint_attn_seq_len(cfg, name)
        phrase = tk.get("p2p_to_multiply") or ""
        if tokenizer is None and not phrase.startswith("ids:"):
            raise RuntimeError(
                "p2p needs a CLIP tokenizer for phrase->token-id mapping "
                "(or pass explicit indices as p2p_to_multiply='ids:1,4')")
        bid = tk.get("target_block_id", -1)
        edit = build_p2p_edit(
            n, seq_len, phrase_target_ids(captions, phrase, tokenizer),
            float(tk.get("p2p_multiplier", 1.9)), t_edit=float(d["t_edit"]),
            block_ids=None if bid in (-1, None) else (int(bid),),
            device=dev)
        edited = session.decode(z, {"context": ctx}, attn_edit=edit)
        out_caps = captions
    else:
        raise NotImplementedError(name)
    mb = d["mini_batch_size"]
    before = decode_images(vae_decode, session.decode(z, {"context": ctx}),
                           mb)
    after = decode_images(vae_decode, edited, mb)
    for i, (b_img, a_img) in enumerate(zip(before, after)):
        save_image(b_img, os.path.join(workdir, f"{i}_before.png"))
        save_image(a_img, os.path.join(workdir, f"{i}_after.png"))
        with open(os.path.join(workdir, f"{i}_caption.txt"), "w") as f:
            f.write(f"{captions[i]}\n-> {out_caps[i]}\n")
    print(f"{name}: {len(before)} before/after pairs -> {workdir}",
          flush=True)
    return workdir


def sampled_image_editing(cfg: dict, session, vae_decode, workdir: str,
                          gen: torch.Generator, tokenizer=None) -> str:
    """Shared noise decoded under each p2p multiplier (the reference's
    ``dissect_lfm_t2i.py:262-373``): one row of the grid a multiplier."""
    d = cfg["dissection"]
    tk = dict(d["token_kwargs"])
    dev = session.device
    split = _split(get_dataset(**cfg["dataset"]))
    samples = [split[i] for i in range(d["mini_batch_size"])]
    captions = [s.get("caption", "") for s in samples]
    ctx = torch.as_tensor(np.stack([s["context"] for s in samples]),
                          device=dev)
    n = len(captions)
    c, h, w = cfg["z_shape"]
    if d.get("fixed_z_path"):
        z = torch.as_tensor(np.load(d["fixed_z_path"]), device=dev)[:n]
    else:
        z = torch.randn((n, h, w, c), generator=gen, device=dev)
    phrase = tk.get("p2p_to_multiply") or ""
    seq_len = _joint_attn_seq_len(cfg, "sampled_image_editing") \
        if phrase else None
    mults = tk.get("p2p_multiplier", 1.9)
    if not isinstance(mults, (list, tuple)):
        mults = [mults]
    rows = []
    for mult in mults:
        edit = None
        if phrase and float(mult) != 1.0:
            if tokenizer is None and not phrase.startswith("ids:"):
                raise RuntimeError(
                    "sampled_image_editing p2p needs a CLIP tokenizer for "
                    "phrase->token-id mapping (or explicit indices as "
                    "p2p_to_multiply='ids:1,4')")
            edit = build_p2p_edit(
                n, seq_len, phrase_target_ids(captions, phrase, tokenizer),
                float(mult), t_edit=float(d["t_edit"]), device=dev)
        lat = session.decode(z, {"context": ctx}, attn_edit=edit)
        rows.append(decode_images(vae_decode, lat, d["mini_batch_size"]))
    out = os.path.join(workdir, "sampled_editing_sweep.png")
    save_image(make_grid(np.concatenate(rows), nrow=n), out)
    with open(os.path.join(workdir, "captions.txt"), "w") as f:
        f.write("\n".join(captions))
    print(f"sampled_image_editing: {len(mults)} multipliers x {n} prompts "
          f"-> {out}", flush=True)
    return out


@torch.no_grad()
def vis_attention(cfg: dict, session, workdir: str, gen: torch.Generator,
                  tokenizer=None) -> str:
    """Per-token heatmaps of the image queries' attention to the context at
    t = 0.1, 0.5 and 0.9 on the dataset's latents (one captured forward a
    time; the reference renders them mid-solve)."""
    _joint_attn_seq_len(cfg, "vis_attention")
    d = cfg["dissection"]
    nnet = cfg["nnet"]
    dev = session.device
    split = _split(get_dataset(**cfg["dataset"]))
    samples = [split[i] for i in range(d["mini_batch_size"])]
    captions = [s.get("caption", "") for s in samples]
    ctx = torch.as_tensor(np.stack([s["context"] for s in samples]),
                          device=dev)
    x = _latents(session, torch.as_tensor(
        np.stack([s["x"] for s in samples]), device=dev), gen)
    bid = d["token_kwargs"].get("target_block_id", -1)
    blocks = (int(bid),) if bid not in (-1, None) else (0,)
    n_img = (nnet["img_size"] // nnet["patch_size"]) ** 2
    vf = make_velocity_fn(session.model, {"context": ctx},
                          capture_attn=blocks)
    for t in (0.1, 0.5, 0.9):
        _, taps = vf(torch.full((x.shape[0],), t, device=dev), x)
        for b in blocks:
            save_attention_maps(
                slice_context_attention(taps[f"attn_{b}"], n_img,
                                        nnet["num_clip_token"]),
                workdir, captions, tokenizer=tokenizer, timestep=t,
                block_id=b)
    print(f"attention maps -> {workdir}", flush=True)
    return workdir


def run(config, dissect_name: Optional[str] = None,
        workdir: str = "dissect_t2i_out", device=None,
        seed: Optional[int] = None, vae_weights: Optional[str] = None,
        **overrides) -> str:
    """One mode of ``config`` (a name or a dict); ``overrides`` replace
    keys of its ``dissection`` block or of ``dissection.token_kwargs``.
    The config's ``seed`` (``seed`` where given) seeds the latents and the
    noise. Returns the path written."""
    cfg = get_config(config)
    d = cfg["dissection"]
    tk = d.setdefault("token_kwargs", {})
    for k, v in overrides.items():
        if v is not None:
            (tk if k in tk else d)[k] = v
    name = d["dissect_name"] = dissect_name or d.get("dissect_name")
    seed = cfg.get("seed", 0) if seed is None else seed
    session, vae_decode = build_session(cfg, device, seed, vae_weights)
    os.makedirs(workdir, exist_ok=True)
    gen = torch.Generator(device=session.device).manual_seed(seed)
    clip, tokenizer = get_clip(cfg)
    if name in ("p2p", "local_prompt"):
        return real_image_editing(cfg, session, vae_decode, workdir, gen,
                                  clip, tokenizer)
    if name == "sampled_image_editing":
        return sampled_image_editing(cfg, session, vae_decode, workdir, gen,
                                     tokenizer)
    if name == "vis_attention":
        return vis_attention(cfg, session, workdir, gen, tokenizer)
    raise NotImplementedError(f"dissect_name={name!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--dissect_name", required=True,
                    choices=["p2p", "local_prompt", "sampled_image_editing",
                             "vis_attention"])
    ap.add_argument("--workdir", default="dissect_t2i_out")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--seed", type=int, default=None,
                    help="default: the config's seed")
    ap.add_argument("--vae_weights", default=None,
                    help=".npz of JAX VAE params: decode to pixels")
    ap.add_argument("--ckpt_path_to_dissect", default=None)
    ap.add_argument("--mini_batch_size", type=int, default=None)
    ap.add_argument("--fixed_z_path", default=None)
    ap.add_argument("--t_edit", type=float, default=None)
    ap.add_argument("--token_dissect", default=None,
                    choices=["lp_replace", "lp_remove", "lp_add"])
    ap.add_argument("--lp_replace_from", default=None)
    ap.add_argument("--lp_replace_to", default=None)
    ap.add_argument("--lp_to_add", default=None)
    ap.add_argument("--lp_to_remove", default=None)
    ap.add_argument("--p2p_to_multiply", default=None,
                    help="a phrase (needs the CLIP tokenizer) or ids:1,4")
    ap.add_argument("--p2p_multiplier", default=None,
                    help="a multiplier, or comma-separated for a sweep")
    ap.add_argument("--target_block_id", type=int, default=None)
    a = vars(ap.parse_args(argv))
    if a["p2p_multiplier"] is not None:
        m = [float(v) for v in a["p2p_multiplier"].split(",")]
        a["p2p_multiplier"] = m[0] if len(m) == 1 else m
    print(run(a.pop("config"), a.pop("dissect_name"), **a))


if __name__ == "__main__":
    main()
