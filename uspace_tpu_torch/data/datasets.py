"""Datasets: the port's own copy of ``uspace_tpu/data/datasets.py`` (numpy
only; the port imports nothing of the JAX package).

The feature datasets read what ``data/extraction.py`` (or the JAX package's
extraction, or the reference's scripts) wrote, in the same on-disk formats:
per-index ``{i}.npy`` VAE moments, plain or pickled with their label or
segmask and attributes (:class:`NpyFeatureDataset`), bulk h5
(:class:`H5FeatureDataset`), and captioned directories of ``{i}.npy``
moments with ``{i}_{k}.npy`` CLIP contexts (:class:`CaptionFeatureDataset`).
Files keep the reference's CHW moments; a sample's ``x`` is HWC. The
synthetic datasets stand in where a config's own features are not in the
repository. Every draw (a caption, a CFG drop, a synthetic sample) is the
JAX package's, bit for bit, for the same seed and epoch. :func:`get_dataset`
takes every name of the JAX registry; batches come from
``data/loader.DataLoader``.

Samples are dicts: ``x`` (moments or latents, HWC), and where the data has
them ``y`` (an int label), ``attr`` (an attribute vector), ``context``
([77, 768] CLIP) and ``caption`` (a string).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class _EpochRng:
    """Per-(epoch, index) generator of the host's draws (a caption, the CFG
    drop, a flip): seeded by (seed, stream, idx, epoch), so draws change
    from one epoch to the next yet do not depend on the loader's thread
    order. The loader announces the epoch through ``set_epoch``. ``stream``
    keeps two users that wrap each other apart."""

    def __init__(self, seed: int, stream: int = 0):
        self.seed = seed
        self.stream = stream
        self.epoch = 0

    def for_index(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.stream, idx,
                                      self.epoch))


def _chw_to_hwc(z: np.ndarray) -> np.ndarray:
    """A file's CHW moments as HWC (other ranks pass unchanged)."""
    if z.ndim == 3:
        return np.transpose(z, (1, 2, 0))
    return z


class Dataset:
    """The map-style protocol: ``len``, ``[idx]`` -> dict, and ``set_epoch``
    (called by the loader before an epoch; nothing by default)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch draws listen here; most datasets have none."""


class NpyFeatureDataset(Dataset):
    """A directory of per-index ``{i}.npy`` feature files in one of four
    formats (``fmt``):

    - ``"plain"``: the file is the moments array (MS-COCO's image files);
    - ``"pair"``: a pickled (z, z) tuple (reference datasets.py:502-514);
    - ``"cond"``: a pickled (z, segmask, attr) tuple, the CelebAMask-HQ
      conditional layout (:517-532): ``x`` and ``attr``;
    - ``"labeled"``: a pickled (z, label) tuple (ImageNet, :173-191): ``x``
      and ``y``.

    ``num`` defaults to the count of ``{i}.npy`` files (no ``_`` in the
    name)."""

    FORMATS = ("plain", "pair", "cond", "labeled")

    def __init__(self, path: str, num: Optional[int] = None,
                 fmt: str = "pair"):
        if fmt not in self.FORMATS:
            raise ValueError(f"fmt {fmt!r}: one of {self.FORMATS}")
        self.path = path
        self.fmt = fmt
        if num is None:
            num = len([f for f in os.listdir(path)
                       if f.endswith(".npy") and "_" not in f])
        self.num = num

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        f = os.path.join(self.path, f"{idx}.npy")
        if self.fmt == "plain":
            return {"x": _chw_to_hwc(np.load(f))}
        obj = np.load(f, allow_pickle=True)
        if self.fmt == "pair":
            return {"x": _chw_to_hwc(np.asarray(obj[0], dtype=np.float32))}
        if self.fmt == "cond":
            z, _segmask, attr = obj
            return {"x": _chw_to_hwc(z), "attr": np.asarray(attr)}
        z, label = obj
        return {"x": _chw_to_hwc(z), "y": np.int32(label)}


class H5FeatureDataset(Dataset):
    """Bulk h5 features: ``train_feat`` [N, 2C, h, w] and, where the file
    has them, ``train_label`` and ``train_attr`` (reference
    datasets.py:416-499). Needs h5py, imported here."""

    def __init__(self, path: str, load_in_mem: bool = True,
                 num: Optional[int] = None):
        import h5py

        self._f = h5py.File(path, "r")
        self.feat = self._f["train_feat"]
        self.label = self._f.get("train_label")
        self.attr = self._f.get("train_attr")
        if load_in_mem:
            self.feat = self.feat[:]
            self.label = self.label[:] if self.label is not None else None
            self.attr = self.attr[:] if self.attr is not None else None
        self.num = num or len(self.feat)

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        out = {"x": _chw_to_hwc(np.copy(self.feat[idx]))}
        if self.label is not None:
            out["y"] = np.int32(np.asarray(self.label[idx]).item())
        if self.attr is not None:
            out["attr"] = np.copy(self.attr[idx])
        return out


def get_feature_dir_info(root: str) -> Tuple[int, Dict[int, int]]:
    """The images (``{i}.npy``) and each image's caption contexts
    (``{i}_{k}.npy``) of a captioned feature directory (reference
    datasets.py:950-960)."""
    num_data = 0
    n_captions: Dict[int, int] = {}
    for name in os.listdir(root):
        stem, ext = os.path.splitext(name)
        if ext != ".npy":
            continue
        parts = stem.split("_")
        if len(parts) == 1 and parts[0].isdigit():
            num_data += 1
        elif len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            k = int(parts[0])
            n_captions[k] = n_captions.get(k, 0) + 1
    return num_data, n_captions


class CaptionFeatureDataset(Dataset):
    """MS-COCO / MM-CelebA-HQ features: ``{i}.npy`` moments and
    ``{i}_{k}.npy`` CLIP contexts (and ``{i}_{k}_captions.txt``), reference
    datasets.py:963-987. A sample's caption k is drawn per index and epoch
    (``_EpochRng(seed)``); ``output_caption`` adds its text."""

    def __init__(self, root: str, output_caption: bool = False,
                 seed: int = 0):
        self.root = root
        self.output_caption = output_caption
        self.num_data, self.n_captions = get_feature_dir_info(root)
        self._rng = _EpochRng(seed)

    def set_epoch(self, epoch: int) -> None:
        self._rng.epoch = epoch

    def __len__(self) -> int:
        return self.num_data

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        z = np.load(os.path.join(self.root, f"{idx}.npy"))
        k = int(self._rng.for_index(idx).integers(0, self.n_captions[idx]))
        c = np.load(os.path.join(self.root, f"{idx}_{k}.npy"))
        out = {"x": _chw_to_hwc(z), "context": c}
        if self.output_caption:
            with open(os.path.join(self.root,
                                   f"{idx}_{k}_captions.txt")) as f:
                caps = [line.strip() for line in f if line.strip()]
            out["caption"] = (caps[k] if k < len(caps)
                              else (caps[0] if caps else ""))
        return out


class SyntheticFeatures(Dataset):
    """Random moments for tests and benchmarks: sample ``idx`` is drawn
    from ``np.random.default_rng(seed + idx)``, so for the same seed it
    equals the JAX package's ``SyntheticFeatures`` sample."""

    def __init__(self, num: int = 256, shape=(32, 32, 8), num_classes: int = 0,
                 context_shape=None, seed: int = 0):
        self.num = num
        self.shape = shape
        self.num_classes = num_classes
        self.context_shape = context_shape
        self.seed = seed

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + idx)
        out = {"x": rng.normal(size=self.shape).astype(np.float32)}
        if self.num_classes:
            out["y"] = np.int32(rng.integers(0, self.num_classes))
        if self.context_shape:
            out["context"] = rng.normal(size=self.context_shape).astype(
                np.float32)
        return out

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The samples at ``indices`` stacked along a new batch axis."""
        items = [self[i] for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


class SyntheticAttrFeatures(Dataset):
    """Attribute-structured synthetic moments for the editing workflow (the
    CelebA / FFHQ latents with attributes are not in the repository). Each
    sample's latent is ``base_std * g(idx) + amp * sum_a attr_a(idx) P_a``
    with per-index Gaussian noise g and fixed orthonormal patterns ``P_a``,
    stored as VAE-style moments (mean ‖ logvar, divided by the SD scale
    factor, so that ``sample_from_moments`` gives x plus small noise). The
    draws are the JAX package's ``SyntheticAttrFeatures``, bit for bit."""

    SCALE = 0.18215  # the SD scale factor of every config's autoencoder

    def __init__(self, num: int = 4096, shape=(8, 8, 8), num_attrs: int = 4,
                 base_std: float = 0.4, amp: float = 1.5,
                 noise_std: float = 0.05, raw: bool = False, seed: int = 0):
        if shape[-1] % 2:
            raise ValueError("moments need mean ‖ logvar channels: the last "
                             f"axis of {tuple(shape)} is odd")
        self.num = num
        self.raw = raw  # the latent itself instead of moments
        self.shape = tuple(shape)
        self.latent_shape = (*self.shape[:-1], self.shape[-1] // 2)
        self.num_attrs = num_attrs
        self.base_std = base_std
        self.amp = amp
        self.noise_std = noise_std
        self.seed = seed
        self._pat = self.patterns(self.latent_shape, num_attrs)

    @staticmethod
    def patterns(latent_shape, num_attrs: int) -> np.ndarray:
        """[A, *latent_shape] fixed orthonormal directions (unit L2)."""
        dim = int(np.prod(latent_shape))
        rng = np.random.default_rng(12345)
        q, _ = np.linalg.qr(rng.normal(size=(dim, num_attrs)))
        return q.T.reshape(num_attrs, *latent_shape).astype(np.float32)

    def attr_of(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 1, idx))
        return (rng.random(self.num_attrs) < 0.5).astype(np.float32)

    def latent_of(self, idx: int, attr=None) -> np.ndarray:
        """The latent of sample ``idx``; ``attr`` is its ``attr_of(idx)``
        where the caller has it already (the same draw)."""
        rng = np.random.default_rng((self.seed, 0, idx))
        g = rng.normal(size=self.latent_shape).astype(np.float32)
        if attr is None:
            attr = self.attr_of(idx)
        return self.base_std * g + self.amp * np.tensordot(
            attr, self._pat, axes=1)

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        attr = self.attr_of(idx)
        latent = self.latent_of(idx, attr)
        if self.raw:
            return {"x": latent, "attr": attr}
        mean = latent / self.SCALE
        logvar = np.full_like(mean, 2.0 * np.log(self.noise_std / self.SCALE))
        return {"x": np.concatenate([mean, logvar], axis=-1), "attr": attr}


class CFGDataset(Dataset):
    """Classifier-free-guidance dropout: with probability ``p_uncond`` a
    sample's conditioning becomes the null one (``empty_context`` for a
    context, ``null_label`` for a label), drawn per index and epoch."""

    def __init__(self, dataset, p_uncond: float, empty_context=None,
                 null_label: Optional[int] = None, seed: int = 0):
        self.dataset = dataset
        self.p_uncond = p_uncond
        self.empty_context = empty_context
        self.null_label = null_label
        self._rng = _EpochRng(seed, stream=1)

    def set_epoch(self, epoch: int) -> None:
        self._rng.epoch = epoch
        set_fn = getattr(self.dataset, "set_epoch", None)
        if set_fn is not None:
            set_fn(epoch)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        out = dict(self.dataset[idx])
        if self._rng.for_index(idx).random() < self.p_uncond:
            if "context" in out and self.empty_context is not None:
                out["context"] = np.asarray(self.empty_context)
            if "y" in out and self.null_label is not None:
                out["y"] = np.int32(self.null_label)
        return out


def _moments(latent: np.ndarray, noise_std: float, scale: float
             ) -> np.ndarray:
    """VAE-style moments of ``latent``: mean ‖ logvar, divided by the SD
    scale factor."""
    mean = latent / scale
    logvar = np.full_like(mean, 2.0 * np.log(noise_std / scale))
    return np.concatenate([mean, logvar], axis=-1)


class SyntheticT2IFeatures(Dataset):
    """Caption-structured synthetic moments for the T2I proofs (MS-COCO's
    latents and CLIP contexts are not in the repository). A sample's
    caption is two distinct words of a ``vocab``-word vocabulary; its latent
    carries their orthonormal patterns and its context their embeddings:
    ``latent = base_std * g(idx) + amp * (P_w1 + P_w2)``, ``context = [0,
    ctx_scale E[w1], ctx_scale E[w2], 0, ...]`` ([num_tokens, ctx_dim], the
    words at rows 1 and 2 as in CLIP's layout behind its start token)."""

    SCALE = 0.18215

    def __init__(self, num: int = 4096, shape=(8, 8, 8), vocab: int = 6,
                 num_tokens: int = 8, ctx_dim: int = 32,
                 base_std: float = 0.35, amp: float = 3.0,
                 noise_std: float = 0.05, ctx_scale: float = 4.0,
                 seed: int = 0):
        if shape[-1] % 2:
            raise ValueError("moments need mean ‖ logvar channels: the last "
                             f"axis of {tuple(shape)} is odd")
        self.num = num
        self.shape = tuple(shape)
        self.latent_shape = (*self.shape[:-1], self.shape[-1] // 2)
        self.vocab = vocab
        self.num_tokens = num_tokens
        self.ctx_dim = ctx_dim
        self.base_std = base_std
        self.amp = amp
        self.noise_std = noise_std
        self.ctx_scale = ctx_scale
        self.seed = seed
        self._pat = SyntheticAttrFeatures.patterns(self.latent_shape, vocab)
        self._emb = self.word_embeddings(ctx_dim, vocab)

    @staticmethod
    def word_embeddings(ctx_dim: int, vocab: int) -> np.ndarray:
        """[V, ctx_dim] fixed orthonormal word embeddings."""
        rng = np.random.default_rng(54321)
        q, _ = np.linalg.qr(rng.normal(size=(ctx_dim, vocab)))
        return np.ascontiguousarray(q.T, dtype=np.float32)

    def words_of(self, idx: int) -> Tuple[int, int]:
        rng = np.random.default_rng((self.seed, 1, idx))
        w1, w2 = rng.choice(self.vocab, size=2, replace=False)
        return int(w1), int(w2)

    def context_of(self, w1: int, w2: int) -> np.ndarray:
        ctx = np.zeros((self.num_tokens, self.ctx_dim), np.float32)
        ctx[1] = self.ctx_scale * self._emb[w1]
        ctx[2] = self.ctx_scale * self._emb[w2]
        return ctx

    def latent_of(self, idx: int, words=None) -> np.ndarray:
        """The latent of sample ``idx``; ``words`` is its ``words_of(idx)``
        where the caller has it already (the same draw)."""
        rng = np.random.default_rng((self.seed, 0, idx))
        g = rng.normal(size=self.latent_shape).astype(np.float32)
        w1, w2 = self.words_of(idx) if words is None else words
        return (self.base_std * g
                + self.amp * (self._pat[w1] + self._pat[w2]))

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        w1, w2 = self.words_of(idx)
        return {"x": _moments(self.latent_of(idx, (w1, w2)), self.noise_std,
                              self.SCALE),
                "context": self.context_of(w1, w2),
                "words": np.asarray([w1, w2], np.int32)}


class SyntheticClassFeatures(Dataset):
    """Class-structured synthetic moments for the class-conditional proof
    (ImageNet's latents and labels are not in the repository): ``x =
    base_std * g(idx) + amp * P_y(idx)``, stored as moments."""

    SCALE = 0.18215

    def __init__(self, num: int = 4096, shape=(4, 4, 8),
                 num_classes: int = 6, base_std: float = 0.35,
                 amp: float = 5.0, noise_std: float = 0.05, seed: int = 0):
        if shape[-1] % 2:
            raise ValueError("moments need mean ‖ logvar channels: the last "
                             f"axis of {tuple(shape)} is odd")
        self.num = num
        self.shape = tuple(shape)
        self.latent_shape = (*self.shape[:-1], self.shape[-1] // 2)
        self.num_classes = num_classes
        self.base_std = base_std
        self.amp = amp
        self.noise_std = noise_std
        self.seed = seed
        self._pat = SyntheticAttrFeatures.patterns(self.latent_shape,
                                                   num_classes)

    def label_of(self, idx: int) -> int:
        rng = np.random.default_rng((self.seed, 1, idx))
        return int(rng.integers(0, self.num_classes))

    def latent_of(self, idx: int, label: Optional[int] = None) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 0, idx))
        g = rng.normal(size=self.latent_shape).astype(np.float32)
        y = self.label_of(idx) if label is None else label
        return self.base_std * g + self.amp * self._pat[y]

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        y = self.label_of(idx)
        return {"x": _moments(self.latent_of(idx, y), self.noise_std,
                              self.SCALE),
                "y": np.int32(y)}


def unpreprocess(images: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1], clipped (reference datasets.py:84-90)."""
    return np.clip((images + 1.0) / 2.0, 0.0, 1.0)


class DatasetFactory:
    """A dataset by its splits (``train``, ``test`` where it has one), its
    latent shape ``data_shape`` (HWC), its classes ``K`` where it is
    labelled, and ``fid_stat``, the FID reference statistics (.npz) of the
    training loop's in-loop FID (reference datasets.py:63-107)."""

    train: Optional[Dataset] = None
    test: Optional[Dataset] = None
    fid_stat: Optional[str] = None
    has_label = False
    K: Optional[int] = None  # number of classes

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return (32, 32, 4)

    def get_split(self, split: str = "train") -> Dataset:
        ds = getattr(self, split, None)
        if ds is None:
            raise ValueError(f"dataset has no split {split!r}")
        return ds

    def sample_label(self, generator: torch.Generator, n_samples: int
                     ) -> torch.Tensor:
        """``n_samples`` labels in [0, K) drawn from ``generator``, on its
        device."""
        if not self.K:
            raise NotImplementedError("unconditional dataset")
        return torch.randint(0, self.K, (n_samples,), generator=generator,
                             device=generator.device)

    unpreprocess = staticmethod(unpreprocess)


def _refuse_cfg(cfg: bool) -> None:
    if cfg:
        raise NotImplementedError(
            "CFG dropout is not defined for this dataset (no null "
            "conditioning); the cfg flag would be silently ignored")


class CM256Features(DatasetFactory):
    """CelebAMask-HQ's 30k latents (reference datasets.py:556-586): the
    ``pair`` layout, or with ``conditional`` the ``cond`` layout (moments,
    segmask, 40 attributes)."""

    fid_stat = "assets/fid_stats/fid_stats_cm256.npz"

    def __init__(self, path: str, cfg: bool = False,
                 p_uncond: Optional[float] = None, num: int = 30_000,
                 conditional: bool = False):
        _refuse_cfg(cfg)
        self.train = NpyFeatureDataset(path, num=num,
                                       fmt="cond" if conditional else "pair")


class CM256FeaturesCond(CM256Features):
    def __init__(self, path: str, cfg: bool = False,
                 p_uncond: Optional[float] = None, num: int = 30_000):
        super().__init__(path, num=num, conditional=True)


class H5Features(DatasetFactory):
    """FFHQ / MetFaces / AFHQ / LSUN churches bulk-h5 latents, with
    attributes where the file has them (reference datasets.py:589-718)."""

    def __init__(self, path: str, cfg: bool = False,
                 p_uncond: Optional[float] = None, num: Optional[int] = None,
                 load_in_mem: bool = True, fid_stat: Optional[str] = None):
        _refuse_cfg(cfg)
        self.train = H5FeatureDataset(path, load_in_mem=load_in_mem, num=num)
        if fid_stat:
            self.fid_stat = fid_stat


class ImageNet256Features(DatasetFactory):
    """ImageNet latents with their labels (the ``labeled`` layout); with
    ``cfg`` a label drops to the learned null class K = 1000 with
    probability ``p_uncond`` (the model has K + 1 classes; evaluation draws
    real classes only)."""

    fid_stat = "assets/fid_stats/fid_stats_imagenet256_guided_diffusion.npz"
    has_label = True

    def __init__(self, path: str, cfg: bool = False,
                 p_uncond: Optional[float] = None, num: int = 1_281_167):
        self.K = 1000
        self.null_label = None
        train = NpyFeatureDataset(path, num=num, fmt="labeled")
        if cfg:
            if p_uncond is None:
                raise ValueError("cfg needs p_uncond")
            self.null_label = self.K
            train = CFGDataset(train, p_uncond, null_label=self.null_label)
        self.train = train


class ImageNet512Features(ImageNet256Features):
    fid_stat = "assets/fid_stats/fid_stats_imagenet512_guided_diffusion.npz"

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return (64, 64, 4)


class MSCOCO256Features(DatasetFactory):
    """MS-COCO latents and CLIP contexts (reference datasets.py:990-1043):
    ``train/`` and ``val/`` captioned feature directories (each held to
    ``expected_sizes`` where given), ``empty_context.npy`` (the CFG null
    context, required by ``cfg``) and ``run_vis/{i}.npy``, the fixed
    evaluation prompts as pickled (prompt, context) pairs: ``prompts`` and
    ``contexts``."""

    fid_stat = "assets/fid_stats/fid_stats_mscoco256_val.npz"

    def __init__(self, path: str, cfg: bool = False,
                 p_uncond: Optional[float] = None,
                 output_caption: bool = False,
                 expected_sizes: Optional[Sequence[int]] = (82783, 40504)):
        self.train = CaptionFeatureDataset(
            os.path.join(path, "train"), output_caption=output_caption)
        self.test = CaptionFeatureDataset(
            os.path.join(path, "val"), output_caption=output_caption)
        if expected_sizes:
            for ds, want in zip((self.train, self.test), expected_sizes):
                if want and len(ds) != want:
                    raise ValueError(f"{ds.root}: {len(ds)} != {want}")
        empty_f = os.path.join(path, "empty_context.npy")
        self.empty_context = (np.load(empty_f) if os.path.exists(empty_f)
                              else None)
        if cfg:
            if p_uncond is None or self.empty_context is None:
                raise ValueError("cfg needs p_uncond and empty_context.npy")
            self.train = CFGDataset(self.train, p_uncond,
                                    empty_context=self.empty_context)
        self.prompts, self.contexts = [], []
        run_vis = os.path.join(path, "run_vis")
        if os.path.isdir(run_vis):
            for f in sorted(os.listdir(run_vis),
                            key=lambda x: int(x.split(".")[0])):
                prompt, context = np.load(os.path.join(run_vis, f),
                                          allow_pickle=True)
                self.prompts.append(prompt)
                self.contexts.append(context)
            self.contexts = np.array(self.contexts)


class MMCelebAHQ256Features(MSCOCO256Features):
    """MM-CelebA-HQ's captioned latents (reference datasets.py:1046-1110):
    MS-COCO's layout without its sizes."""

    fid_stat = "assets/fid_stats/fid_stats_mmcelebahq256.npz"

    def __init__(self, path: str, cfg: bool = False,
                 p_uncond: Optional[float] = None,
                 output_caption: bool = False):
        super().__init__(path, cfg=cfg, p_uncond=p_uncond,
                         output_caption=output_caption, expected_sizes=None)


class Synthetic(DatasetFactory):
    """The ``synthetic`` dataset: ``SyntheticFeatures`` moments of
    ``shape`` (H, W, 2 x latent channels), ``num`` train samples from seed
    0 and a test split of ``num // 4`` from seed 10000, as the JAX
    package's ``Synthetic`` factory draws them."""

    def __init__(self, num: int = 256, shape=(32, 32, 8),
                 num_classes: int = 0, context_shape=None, **_):
        self.train = SyntheticFeatures(num, shape, num_classes, context_shape)
        self.test = SyntheticFeatures(max(num // 4, 1), shape, num_classes,
                                      context_shape, seed=10_000)
        if num_classes:
            self.K = num_classes
            self.has_label = True

    @property
    def data_shape(self) -> Tuple[int, ...]:
        h, w, c2 = self.train.shape
        return (h, w, c2 // 2)


class SyntheticAttr(DatasetFactory):
    """The ``synthetic_attr`` dataset: ``SyntheticAttrFeatures`` train and
    test splits (the test split from seed 10000)."""

    def __init__(self, num: int = 4096, shape=(8, 8, 8), num_attrs: int = 4,
                 base_std: float = 0.4, amp: float = 1.5,
                 noise_std: float = 0.05, raw: bool = False, **_):
        self.train = SyntheticAttrFeatures(num, shape, num_attrs, base_std,
                                           amp, noise_std, raw)
        self.test = SyntheticAttrFeatures(max(num // 8, 1), shape, num_attrs,
                                          base_std, amp, noise_std, raw,
                                          seed=10_000)

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return self.test.latent_shape


class SyntheticT2I(DatasetFactory):
    """The ``synthetic_t2i`` dataset: ``SyntheticT2IFeatures`` train and
    test splits (the test split from seed 10000), the zeros context as the
    null conditioning (``empty_context``), and with ``cfg`` the train
    split's context dropped to it with probability ``p_uncond``."""

    def __init__(self, num: int = 4096, shape=(8, 8, 8), vocab: int = 6,
                 num_tokens: int = 8, ctx_dim: int = 32,
                 base_std: float = 0.35, amp: float = 3.0,
                 noise_std: float = 0.05, ctx_scale: float = 4.0,
                 cfg: bool = False, p_uncond: Optional[float] = None, **_):
        args = (shape, vocab, num_tokens, ctx_dim, base_std, amp, noise_std,
                ctx_scale)
        self.train = SyntheticT2IFeatures(num, *args)
        self.test = SyntheticT2IFeatures(max(num // 8, 1), *args,
                                         seed=10_000)
        self.empty_context = np.zeros((num_tokens, ctx_dim), np.float32)
        if cfg:
            if p_uncond is None:
                raise ValueError("cfg needs p_uncond")
            self.train = CFGDataset(self.train, p_uncond,
                                    empty_context=self.empty_context)

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return self.test.latent_shape


class SyntheticClass(DatasetFactory):
    """The ``synthetic_class`` dataset: ``SyntheticClassFeatures`` splits
    with labels 0..K-1; with ``cfg`` a train label drops to the learned
    null class K (the model has K + 1 classes) with probability
    ``p_uncond``."""

    has_label = True

    def __init__(self, num: int = 4096, shape=(4, 4, 8),
                 num_classes: int = 6, base_std: float = 0.35,
                 amp: float = 5.0, noise_std: float = 0.05,
                 cfg: bool = False, p_uncond: Optional[float] = None, **_):
        self.K = num_classes
        self.null_label = None
        args = (shape, num_classes, base_std, amp, noise_std)
        self.train = SyntheticClassFeatures(num, *args)
        self.test = SyntheticClassFeatures(max(num // 8, 1), *args,
                                           seed=10_000)
        if cfg:
            if p_uncond is None:
                raise ValueError("cfg needs p_uncond")
            self.null_label = self.K
            self.train = CFGDataset(self.train, p_uncond,
                                    null_label=self.null_label)

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return self.test.latent_shape


class _ImagesAsX(Dataset):
    """A raw image dataset's samples with the image as ``x`` (its path
    dropped)."""

    def __init__(self, base: Dataset):
        self.base = base

    def set_epoch(self, epoch: int) -> None:
        set_fn = getattr(self.base, "set_epoch", None)
        if set_fn is not None:
            set_fn(epoch)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        s = dict(self.base[idx])
        s["x"] = s.pop("image")
        s.pop("path", None)
        return s


class RawImages(DatasetFactory):
    """Raw image folders (the reference's real_img / ffhq256 / celeba
    entries): an ``ImageFolder``, or with ``attr_file`` CelebAMask-HQ with
    its attributes, each image as ``x`` in [-1, 1] (pixel-space training;
    extraction reads ``data/raw.py`` directly)."""

    def __init__(self, path: str, resolution: int = 256,
                 attr_file: Optional[str] = None,
                 mapping_file: Optional[str] = None, **_):
        from .raw import CelebAMaskHQ, ImageFolder

        if attr_file:
            self.train = _ImagesAsX(CelebAMaskHQ(path, resolution, attr_file,
                                                 mapping_file=mapping_file))
        else:
            self.train = _ImagesAsX(ImageFolder(path, resolution))
        self.resolution = resolution

    @property
    def data_shape(self) -> Tuple[int, ...]:
        return (self.resolution, self.resolution, 3)


# the JAX registry's names (uspace_tpu/data/datasets.py:718-739)
_REGISTRY = {
    "celebamask256_features": CM256Features,
    "celebamask256_features_cond": CM256FeaturesCond,
    "ffhq256_features": H5Features,
    "metfaces256_features": H5Features,
    "AFHQ256_cat_features": H5Features,
    "AFHQ256_dog_features": H5Features,
    "churches256_features": H5Features,
    "imagenet256_features": ImageNet256Features,
    "imagenet512_features": ImageNet512Features,
    "mscoco256_features": MSCOCO256Features,
    "mmcelebahq256_features_withcaptioncontext": MMCelebAHQ256Features,
    "synthetic": Synthetic,
    "synthetic_attr": SyntheticAttr,
    "synthetic_t2i": SyntheticT2I,
    "synthetic_class": SyntheticClass,
    "real_img": RawImages,
    "ffhq256": RawImages,
    "celeba": RawImages,
    "imagenet": RawImages,
    "cifar10": RawImages,
}
# MS-COCO with its captions' text (``output_caption``)
CAPTION_ALIAS = "mscoco256_features_withcaptioncontext"


def get_dataset(name: str, **kwargs) -> DatasetFactory:
    """A dataset by its config name: every name of the JAX registry, and
    ``mscoco256_features_withcaptioncontext`` (MS-COCO with
    ``output_caption``). ``fid_stat`` names the FID reference statistics
    of any of them (the training loop's in-loop FID), in place of the
    dataset's own."""
    fid_stat = kwargs.pop("fid_stat", None)
    if name == CAPTION_ALIAS:
        dataset = MSCOCO256Features(output_caption=True, **kwargs)
    elif name in _REGISTRY:
        dataset = _REGISTRY[name](**kwargs)
    else:
        raise NotImplementedError(name)
    if fid_stat:
        dataset.fid_stat = fid_stat
    return dataset
