"""Raw image datasets that feed feature extraction (counterpart of
``uspace_tpu/data/raw.py``; the reference's ``lfm_dataset/`` adapters and
the raw entries of its ``datasets.py``): CelebAMask-HQ with its 40
attributes, FFHQ with its 11, captioned image folders (MM-CelebA-HQ),
MS-COCO's annotation file, LSUN-style path lists, ImageNet class subsets
and plain image folders.

Every sample's ``image`` is [H, W, 3] float32 in [-1, 1] (a centre crop,
PIL's bicubic resize, then x / 127.5 - 1), with ``attr``, ``y``,
``captions`` or ``path`` where the dataset has them. Decoding is the
host's PIL, imported inside the functions that read an image.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..editing.directions import FFHQ_ATTR11
from .datasets import Dataset, _EpochRng

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_images(root: str, recursive: bool = True) -> List[str]:
    """The image files under ``root`` in sorted order (walking its
    subdirectories, in sorted order, with ``recursive``)."""
    if not recursive:
        return [os.path.join(root, f) for f in sorted(os.listdir(root))
                if f.lower().endswith(IMG_EXTS)]
    out = []
    for base, _dirs, files in sorted(os.walk(root)):
        out.extend(os.path.join(base, f) for f in sorted(files)
                   if f.lower().endswith(IMG_EXTS))
    return out


def load_image(path: str, resolution: Optional[int] = None,
               center_crop: bool = True, resample=None) -> np.ndarray:
    """[H, W, 3] float32 in [-1, 1]: RGB, with ``resolution`` the centre
    square (``center_crop``) resized to ``resolution`` by ``resample``
    (PIL's bicubic by default)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if resolution is not None:
        if center_crop:
            w, h = img.size
            s = min(w, h)
            img = img.crop(((w - s) // 2, (h - s) // 2,
                            (w + s) // 2, (h + s) // 2))
        img = img.resize((resolution, resolution),
                         resample or Image.BICUBIC)
    return np.asarray(img, np.float32) / 127.5 - 1.0


class ImageFolder(Dataset):
    """A folder of images (the reference's Real_IMG_DS, FFHQ, AFHQ,
    MetFaces and churches adapters): ``image`` and ``path``."""

    def __init__(self, path: str, resolution: int = 256,
                 recursive: bool = True):
        self.files = list_images(path, recursive)
        if not self.files:
            raise FileNotFoundError(f"no images under {path}")
        self.resolution = resolution

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        return {"image": load_image(self.files[idx], self.resolution),
                "path": self.files[idx]}


def parse_celeba_attrs(attr_file: str) -> Dict[str, np.ndarray]:
    """A CelebA(-HQ) ``list_attr`` file: file name -> its 40 attributes as
    0/1 int64 (-1 -> 0; reference lfm_dataset/celeba.py:17-60). Line 0 is
    the count, line 1 the names, then a file name and 40 values a line."""
    with open(attr_file) as f:
        lines = [line.rstrip() for line in f if line.strip()]
    names = lines[1].split()
    out = {}
    for line in lines[2:]:
        parts = line.split()
        vals = np.array([1 if int(v) == 1 else 0 for v in parts[1:]],
                        np.int64)
        if len(vals) != len(names):
            raise ValueError(f"{attr_file}: {parts[0]} has {len(vals)} "
                             f"values for {len(names)} attributes")
        out[parts[0]] = vals
    return out


def _hq_mapping(mapping_file: Optional[str]) -> Dict[int, str]:
    """CelebA-HQ-to-CelebA-mapping.txt: HQ index -> the original file name
    (its header line skipped; rows ``idx orig_idx orig_file``)."""
    mapping: Dict[int, str] = {}
    if mapping_file and os.path.exists(mapping_file):
        with open(mapping_file) as f:
            f.readline()
            for line in f:
                parts = line.split()
                mapping[int(parts[0])] = parts[-1]
    return mapping


class CelebAMaskHQ(Dataset):
    """CelebAMask-HQ images (``CelebA-HQ-img/`` under ``path``, or ``path``
    itself) with the 40 CelebA attributes of ``attr_file`` (reference
    lfm_dataset/celebamask30k_1024.py:84-238): an HQ image ``{i}.jpg``
    takes the attribute row of its original CelebA file through
    ``mapping_file``, else of ``{i}.jpg``. No row matching any image is an
    error; a few missing rows are zeros, with a warning."""

    def __init__(self, path: str, resolution: int = 256,
                 attr_file: Optional[str] = None,
                 mapping_file: Optional[str] = None):
        img_dir = os.path.join(path, "CelebA-HQ-img")
        if not os.path.isdir(img_dir):
            img_dir = path
        self.files = list_images(img_dir, recursive=False)
        self.resolution = resolution
        self.attrs = None
        if not attr_file:
            return
        if not os.path.exists(attr_file):
            raise FileNotFoundError(
                f"attr_file {attr_file!r} does not exist (a silent "
                "fallback would train without attributes)")
        by_name = parse_celeba_attrs(attr_file)
        mapping = _hq_mapping(mapping_file)
        self.attrs = []
        misses = 0
        for fpath in self.files:
            stem = os.path.splitext(os.path.basename(fpath))[0]
            orig = (mapping.get(int(stem), f"{stem}.jpg") if stem.isdigit()
                    else f"{stem}.jpg")
            row = by_name.get(orig)
            if row is None:
                misses += 1
                row = np.zeros(40, np.int64)
            self.attrs.append(row)
        if misses == len(self.files):
            # HQ stems ('0'..'29999') against CelebA's zero-padded names
            # ('000001.jpg'): without the mapping every lookup misses
            raise ValueError(
                f"no attr rows matched any of {len(self.files)} images "
                f"in {attr_file}; pass mapping_file "
                "(CelebA-HQ-to-CelebA-mapping.txt)")
        if misses:
            import warnings

            warnings.warn(f"{misses}/{len(self.files)} images have no "
                          "attr row (zeros substituted)")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        out = {"image": load_image(self.files[idx], self.resolution)}
        if self.attrs is not None:
            out["attr"] = self.attrs[idx]
        return out


class CaptionedImageFolder(Dataset):
    """Images with sidecar caption files (the reference's MMCelebAHQ,
    datasets.py:836-906): image ``{i}.jpg`` and ``{i}.txt`` in
    ``caption_dir`` (the image folder by default), one caption a line;
    ``captions`` is ``[""]`` where there is none."""

    def __init__(self, image_dir: str, caption_dir: Optional[str] = None,
                 resolution: int = 256):
        self.files = list_images(image_dir, recursive=False)
        self.caption_dir = caption_dir or image_dir
        self.resolution = resolution

    def __len__(self) -> int:
        return len(self.files)

    def captions_for(self, idx: int) -> List[str]:
        stem = os.path.splitext(os.path.basename(self.files[idx]))[0]
        cap_file = os.path.join(self.caption_dir, stem + ".txt")
        if not os.path.exists(cap_file):
            return [""]
        with open(cap_file) as f:
            caps = [line.strip() for line in f if line.strip()]
        return caps or [""]

    def __getitem__(self, idx: int) -> Dict:
        return {"image": load_image(self.files[idx], self.resolution),
                "captions": self.captions_for(idx)}


class TxtListedImages(Dataset):
    """Images listed in a text file relative to ``data_root`` (the
    reference's LSUN adapter, lfm_dataset/lsun.py:10-64: a centre crop and
    a horizontal flip with probability ``flip_p``). The flip is drawn per
    index and epoch from ``_EpochRng(seed)``: it changes with the epoch
    and repeats bit for bit."""

    def __init__(self, txt_file: str, data_root: str, resolution: int = 256,
                 flip_p: float = 0.5, seed: int = 0):
        with open(txt_file) as f:
            names = [line.strip() for line in f if line.strip()]
        self.files = [os.path.join(data_root, n) for n in names]
        if not self.files:
            raise FileNotFoundError(f"empty list {txt_file}")
        self.resolution = resolution
        self.flip_p = flip_p
        self._rng = _EpochRng(seed)

    def set_epoch(self, epoch: int) -> None:
        self._rng.epoch = epoch

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        img = load_image(self.files[idx], self.resolution)
        if self.flip_p > 0 and self._rng.for_index(idx).random() < self.flip_p:
            img = img[:, ::-1].copy()
        return {"image": img, "path": self.files[idx]}


# FFHQ's 11 attributes in order (reference lfm_dataset/ffhq_from1024.py:
# 114-139): gender, smile, no glasses, then eight emotions
FFHQ_ATTR11_KEYS = tuple(FFHQ_ATTR11)
_EMOTIONS = FFHQ_ATTR11_KEYS[3:]


def face_attributes_to_attr11(face: Dict) -> np.ndarray:
    """An MS Face API ``faceAttributes`` dict -> its 11 attributes as 0/1
    int64, at the reference's thresholds (ffhq_from1024.py:114-139)."""
    emotion = face["emotion"]
    vals = [0 if face["gender"] == "female" else 1,
            1 if face["smile"] > 0.5 else 0,
            1 if face["glasses"] == "NoGlasses" else 0]
    vals += [1 if emotion[k] > 0.5 else 0 for k in _EMOTIONS]
    return np.array(vals, np.int64)


def load_ffhq_attr11(path: str) -> Dict[str, np.ndarray]:
    """FFHQ's 11 attributes by image id, from either of the reference's
    sources: one JSON of id -> 11 values
    (``lfm_dataset/data_files/ffhq_train_attr_v2.json``), or a directory of
    per-image ``{id}.json`` MS Face API files (``ffhq-features-dataset/
    json``, ffhq_from1024.py:103-139; images without a face are left
    out)."""
    out: Dict[str, np.ndarray] = {}
    if not os.path.isdir(path):
        with open(path) as f:
            data = json.load(f)
        return {str(k): np.asarray(v, np.int64) for k, v in data.items()}
    for name in sorted(os.listdir(path)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(path, name)) as f:
            try:
                attr = face_attributes_to_attr11(
                    json.load(f)[0]["faceAttributes"])
            except (KeyError, IndexError, ValueError):
                continue
        out[os.path.splitext(name)[0]] = attr
    return out


class FFHQAttr11(Dataset):
    """FFHQ images with their 11 attributes (reference ffhq_from1024.py):
    the images of ``split_file`` (relative names, else every image under
    ``root``) that have attributes, resized bilinear without a crop (FFHQ
    is square)."""

    def __init__(self, root: str, attr_path: str,
                 split_file: Optional[str] = None, resolution: int = 256):
        if split_file:
            with open(split_file) as f:
                names = [line.strip() for line in f if line.strip()]
            files = [os.path.join(root, n) for n in names]
        else:
            files = list_images(root)
        attrs = load_ffhq_attr11(attr_path)
        self.files, self.attrs = [], []
        for fpath in files:
            img_id = os.path.splitext(os.path.basename(fpath))[0]
            if img_id in attrs:
                self.files.append(fpath)
                self.attrs.append(attrs[img_id])
        if not self.files:
            raise FileNotFoundError(
                f"no images in {root} with attrs in {attr_path}")
        self.resolution = resolution

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        return {"image": load_image(self.files[idx], self.resolution,
                                    center_crop=False,
                                    resample=Image.BILINEAR),
                "attr": self.attrs[idx]}


class ImageNet100(Dataset):
    """An ImageNet class subset (reference lfm_dataset/imagenet100.py):
    ``class_list_file`` names one wnid folder under ``root`` a line, and an
    image's label ``y`` is its wnid's line."""

    def __init__(self, root: str, class_list_file: str,
                 resolution: int = 256):
        with open(class_list_file) as f:
            self.wnids = [line.strip() for line in f if line.strip()]
        self.files: List[str] = []
        self.labels: List[int] = []
        for cls_id, wnid in enumerate(self.wnids):
            folder = os.path.join(root, wnid)
            if not os.path.isdir(folder):
                raise FileNotFoundError(folder)
            for fpath in list_images(folder, recursive=False):
                self.files.append(fpath)
                self.labels.append(cls_id)
        self.resolution = resolution

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        return {"image": load_image(self.files[idx], self.resolution),
                "y": np.int64(self.labels[idx])}


class MSCOCODatabase(Dataset):
    """MS-COCO images with their captions (reference datasets.py:909-947),
    read from the annotation JSON itself (no pycocotools): images by id,
    each with its annotations' captions in file order."""

    def __init__(self, root: str, annFile: str, size: int = 256):
        self.root = root
        self.size = size
        with open(annFile) as f:
            ann = json.load(f)
        self.images = sorted(ann["images"], key=lambda x: x["id"])
        caps: Dict[int, List[str]] = {}
        for a in ann["annotations"]:
            caps.setdefault(a["image_id"], []).append(a["caption"])
        self.captions = caps

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict:
        info = self.images[idx]
        return {"image": load_image(os.path.join(self.root,
                                                 info["file_name"]),
                                    self.size),
                "captions": self.captions.get(info["id"], [""])}
