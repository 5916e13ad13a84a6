"""Feature extraction (counterpart of ``uspace_tpu/cli/extract_features.py``,
which replaces the reference's per-dataset scripts under ``scripts/``):
raw images -> SD-VAE moments on the card (and CLIP contexts), written in
the formats the feature datasets read.

    python -m uspace_tpu_torch.cli.extract_features \\
        --images /data/celebamask/CelebA-HQ-img --resolution 256 \\
        --vae assets/stable-diffusion/autoencoder_kl.pth \\
        --out assets/datasets/celebamask256_features --format npy

    # T2I (images with sidecar caption .txt files, and CLIP):
    ... --captions /data/mmcelebahq/captions --clip <clip_dir> --format t2i

    # with it, CFG's null context and fixed evaluation prompts:
    ... --empty_context --prompts "a cat,a dog"

The raw dataset follows the flags in the JAX CLI's order: ``--ann_file``
(MS-COCO), ``--format t2i`` or ``--captions`` (captioned folder),
``--ffhq_attr`` (FFHQ with 11 attributes), ``--class_list`` (ImageNet
subset), ``--list_file`` (LSUN-style list, no flips), ``--attr_file``
(CelebAMask-HQ with 40 attributes), else an image folder. ``--format h5``
needs h5py; ``--format t2i`` needs ``--clip``: a directory of Hugging Face
CLIP-L/14 text weights (``pytorch_model.bin``) and its tokenizer files,
read with transformers. ``--device cpu`` runs on the CPU; the card is the
default.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Sequence

from .. import resolve_device
from ..codecs.vae import AutoencoderKL
from ..data import extraction


def build_text_encoder(clip: str, device=None
                       ) -> Callable[[Sequence[str]], "torch.Tensor"]:
    """captions -> [n, 77, 768] CLIP-L/14 contexts (on ``device``) from
    ``clip``: a directory with ``pytorch_model.bin`` and the tokenizer's
    files, or the weights file itself beside them (transformers'
    ``CLIPTokenizer``, imported here, tokenizes)."""
    import transformers

    from ..codecs import clip_text
    from ..codecs.convert import load_torch_checkpoint

    weights = os.path.join(clip, "pytorch_model.bin")
    if not os.path.exists(weights):
        weights = clip  # the weights file itself
    tokenizer = transformers.CLIPTokenizer.from_pretrained(
        clip if os.path.isdir(clip) else os.path.dirname(clip))
    cfg = clip_text.CLIP_L14
    enc = clip_text.CLIPTextEncoder(**cfg, device=resolve_device(device))
    enc.load_state_dict(clip_text.clip_hf_to_torch(
        load_torch_checkpoint(weights)), strict=True)
    return clip_text.FrozenCLIPEmbedder(enc.eval(), tokenizer,
                                        cfg["max_length"]).encode


def raw_dataset(a: argparse.Namespace):
    """The raw dataset the flags name (the JAX CLI's choice)."""
    from ..data.raw import (
        CaptionedImageFolder,
        CelebAMaskHQ,
        FFHQAttr11,
        ImageFolder,
        ImageNet100,
        MSCOCODatabase,
        TxtListedImages,
    )

    if a.ann_file:
        return MSCOCODatabase(a.images, a.ann_file, a.resolution)
    if a.format == "t2i" or a.captions:
        return CaptionedImageFolder(a.images, a.captions, a.resolution)
    if a.ffhq_attr:
        return FFHQAttr11(a.images, a.ffhq_attr, a.list_file, a.resolution)
    if a.class_list:
        return ImageNet100(a.images, a.class_list, a.resolution)
    if a.list_file:
        # extraction is a deterministic offline job: no flip augmentation
        return TxtListedImages(a.list_file, a.images, a.resolution,
                               flip_p=0.0)
    if a.attr_file:
        return CelebAMaskHQ(a.images, a.resolution, a.attr_file)
    return ImageFolder(a.images, a.resolution)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", required=True,
                    help="raw image dir (or MS-COCO root)")
    ap.add_argument("--captions", default=None,
                    help="caption dir (sidecar txt) if separate")
    ap.add_argument("--ann_file", default=None,
                    help="MS-COCO annotation json (MSCOCODatabase)")
    ap.add_argument("--attr_file", default=None,
                    help="CelebA list_attr file (adds attrs)")
    ap.add_argument("--ffhq_attr", default=None,
                    help="FFHQ attr11 source: a consolidated json or a dir "
                    "of per-image MS Face API jsons")
    ap.add_argument("--list_file", default=None,
                    help="txt of image paths relative to --images (LSUN "
                    "lists; FFHQ split lists with --ffhq_attr)")
    ap.add_argument("--class_list", default=None,
                    help="wnid-per-line class list (ImageNet subset; label "
                    "= line index)")
    ap.add_argument("--vae", default="assets/stable-diffusion/"
                    "autoencoder_kl.pth", help="the reference SD VAE .pth")
    ap.add_argument("--clip", default=None,
                    help="local CLIP dir (HF text weights + tokenizer)")
    ap.add_argument("--out", required=True, help="output dir / h5 path")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--format", choices=("npy", "h5", "t2i"), default="npy")
    ap.add_argument("--flip", action="store_true",
                    help="add horizontally flipped copies (npy)")
    ap.add_argument("--empty_context", action="store_true",
                    help="also write empty_context.npy (t2i)")
    ap.add_argument("--prompts", default=None,
                    help="comma-separated eval prompts for run_vis/ (t2i)")
    ap.add_argument("--device", default=None, help="default: cuda")
    return ap


def main(argv=None) -> str:
    ap = parser()
    a = ap.parse_args(argv)
    if a.format == "t2i" and not a.clip:
        ap.error("--format=t2i encodes captions and requires --clip (a local "
                 "CLIP dir with torch weights + tokenizer)")
    ds = raw_dataset(a)
    encode_moments = extraction.make_vae_encoder(
        AutoencoderKL.from_reference(a.vae, device=resolve_device(a.device)))
    if a.format == "npy":
        extraction.extract_features_npy(ds, encode_moments, a.out,
                                        a.batch_size, flip=a.flip)
    elif a.format == "h5":
        extraction.extract_features_h5(ds, encode_moments, a.out,
                                       a.batch_size)
    else:
        encode_text = build_text_encoder(a.clip, a.device)
        extraction.extract_t2i_features(ds, encode_moments, encode_text,
                                        a.out, a.batch_size)
        root = os.path.dirname(a.out)
        if a.empty_context:
            extraction.extract_empty_context(encode_text, root)
        if a.prompts:
            extraction.extract_test_prompts(a.prompts.split(","),
                                            encode_text, root)
    print(f"features -> {a.out}", flush=True)
    return a.out


if __name__ == "__main__":
    main()
