"""Offline feature extraction: raw images -> VAE moments (and CLIP contexts)
on disk, in the formats the feature datasets read (counterpart of
``uspace_tpu/data/extraction.py``, which replaces the reference's
per-dataset scripts under ``scripts/``):

- per-index ``{i}.npy`` pickled ``(moments, label)`` or ``(moments,
  segmask, attr)`` tuples (extract_celebamask_feature*.py:48-64);
- captioned directories: ``{i}.npy`` moments, ``{i}_{k}.npy`` CLIP
  contexts and ``{i}_{k}_captions.txt`` (extract_mscoco_feature.py:50-64);
- bulk h5 ``train_feat`` / ``train_attr`` (h5_extract_*.py; needs h5py);
- ``empty_context.npy``, the CFG null context (extract_empty_feature.py);
- ``run_vis/{i}.npy`` pickled (prompt, context) evaluation prompts
  (extract_test_prompt_feature.py).

Every file is written by the calls the JAX package's writers make, so the
two packages' files are byte for byte the same for the same moments and
contexts. Moments are stored CHW, as the reference's datasets are (the
loaders read them back as HWC). The encoder is the port's SD VAE
(``codecs/vae.AutoencoderKL.encode_moments``; the reference's weights load
through ``AutoencoderKL.from_reference``) on its device, in exact f32.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging_utils import logger
from .datasets import Dataset


def _to_chw(moments_nhwc: np.ndarray) -> np.ndarray:
    return np.transpose(moments_nhwc, (0, 3, 1, 2))


def _numpy(a) -> np.ndarray:
    """An encoder's output on the host (a tensor is copied off its
    device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def make_vae_encoder(vae) -> Callable[[np.ndarray], np.ndarray]:
    """``encode_moments``: images [B, H, W, 3] in [-1, 1] (numpy or a
    tensor) -> posterior moments [B, h, w, 2 * embed] as f32 numpy, on the
    VAE's device, in exact f32 (``codecs/vae.f32_precision``: no TF32 on the
    card)."""
    dev = next(vae.parameters()).device

    @torch.no_grad()
    def encode_moments(images) -> np.ndarray:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images,
                                                           np.float32))
        return _numpy(vae.encode_moments(images.to(dev)))

    return encode_moments


def _batched(dataset: Dataset, batch_size: int
             ) -> Iterator[Tuple[int, List[dict]]]:
    n = len(dataset)
    for start in range(0, n, batch_size):
        yield start, [dataset[i] for i in range(start,
                                                min(start + batch_size, n))]


def extract_features_npy(dataset: Dataset, encode_moments: Callable,
                         out_dir: str, batch_size: int = 64,
                         flip: bool = False) -> int:
    """``{i}.npy`` a sample: pickled ``(moments, segmask, attr)`` where the
    sample has ``attr`` (its ``segmask``, else a [1] uint8 zero), else
    ``(moments, label)`` (its ``y``, else 0). ``flip`` adds each image's
    horizontal mirror at index n + i (the reference's flip-augmented
    ImageNet extraction). Returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    count = 0
    for start, samples in _batched(dataset, batch_size):
        imgs = np.stack([s["image"] for s in samples])
        variants = [(0, imgs)]
        if flip:
            variants.append((n, imgs[:, :, ::-1]))
        for offset, batch in variants:
            moments = _to_chw(_numpy(encode_moments(batch)))
            for j, s in enumerate(samples):
                if "attr" in s:
                    seg = s.get("segmask", np.zeros((1,), np.uint8))
                    obj = np.array((moments[j], seg, np.asarray(s["attr"])),
                                   dtype=object)
                else:
                    obj = np.array((moments[j], np.int64(s.get("y", 0))),
                                   dtype=object)
                np.save(os.path.join(out_dir, f"{offset + start + j}.npy"),
                        obj, allow_pickle=True)
                count += 1
    logger.info("extracted %d feature files -> %s", count, out_dir)
    return count


def extract_features_h5(dataset: Dataset, encode_moments: Callable,
                        out_path: str, batch_size: int = 64) -> int:
    """One h5 file: ``train_feat`` [N, 2C, h, w], and ``train_attr`` where
    the samples have ``attr``. Needs h5py, imported here. Returns N."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    feats, attrs = [], []
    for _start, samples in _batched(dataset, batch_size):
        imgs = np.stack([s["image"] for s in samples])
        feats.append(_to_chw(_numpy(encode_moments(imgs))))
        if "attr" in samples[0]:
            attrs.append(np.stack([s["attr"] for s in samples]))
    feats = np.concatenate(feats)
    with h5py.File(out_path, "w") as f:
        f["train_feat"] = feats
        if attrs:
            f["train_attr"] = np.concatenate(attrs)
    logger.info("extracted %d features -> %s", len(feats), out_path)
    return len(feats)


def extract_t2i_features(dataset: Dataset, encode_moments: Callable,
                         encode_text: Callable[[Sequence[str]], np.ndarray],
                         out_dir: str, batch_size: int = 32) -> int:
    """The MS-COCO / MM-CelebA-HQ layout: ``{i}.npy`` moments, and for
    caption k of the sample's ``captions`` its context ``{i}_{k}.npy`` and
    ``{i}_{k}_captions.txt`` holding all its captions (reference
    extract_mscoco_feature.py:50-64,
    extract_mmcelebahq_feature_with_caption_context.py:39-57). Returns the
    images written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for start, samples in _batched(dataset, batch_size):
        imgs = np.stack([s["image"] for s in samples])
        moments = _to_chw(_numpy(encode_moments(imgs)))
        for j, s in enumerate(samples):
            i = start + j
            np.save(os.path.join(out_dir, f"{i}.npy"), moments[j])
            caps = s.get("captions") or [""]
            ctxs = _numpy(encode_text(caps))
            for k, (_cap, ctx) in enumerate(zip(caps, ctxs)):
                np.save(os.path.join(out_dir, f"{i}_{k}.npy"), ctx)
                with open(os.path.join(out_dir, f"{i}_{k}_captions.txt"),
                          "w") as f:
                    f.write("\n".join(caps) + "\n")
            count += 1
    logger.info("extracted %d t2i feature sets -> %s", count, out_dir)
    return count


def extract_empty_context(encode_text: Callable, out_dir: str) -> str:
    """``empty_context.npy``: the context of the empty prompt, CFG's null
    conditioning (extract_empty_feature.py:17-30). Returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "empty_context.npy")
    np.save(path, _numpy(encode_text([""]))[0])
    return path


def extract_test_prompts(prompts: Sequence[str], encode_text: Callable,
                         out_dir: str) -> str:
    """``run_vis/{i}.npy``: the fixed evaluation prompts as pickled
    (prompt, context) pairs (extract_test_prompt_feature.py). Returns the
    directory."""
    run_vis = os.path.join(out_dir, "run_vis")
    os.makedirs(run_vis, exist_ok=True)
    ctxs = _numpy(encode_text(list(prompts)))
    for i, (p, c) in enumerate(zip(prompts, ctxs)):
        np.save(os.path.join(run_vis, f"{i}.npy"),
                np.array((p, c), dtype=object), allow_pickle=True)
    return run_vis
