"""Feature datasets: the port's own copy of what its slices need from
``uspace_tpu/data/datasets.py`` (numpy only; the port imports nothing of
the JAX package), with the ``get_dataset`` factory of the synthetic
datasets (``synthetic``, ``synthetic_attr``, ``synthetic_t2i``,
``synthetic_class``) and the classifier-free-guidance wrapper
:class:`CFGDataset`. Every draw is the JAX package's, bit for bit, for the
same seed and epoch. Batches come from ``data/loader.DataLoader``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class _EpochRng:
    """Per-(epoch, index) generator of the host's draws (the CFG drop):
    seeded by (seed, stream, idx, epoch), so draws change from one epoch to
    the next yet do not depend on the loader's thread order. The loader
    announces the epoch through ``set_epoch``. ``stream`` keeps two users
    that wrap each other apart."""

    def __init__(self, seed: int, stream: int = 0):
        self.seed = seed
        self.stream = stream
        self.epoch = 0

    def for_index(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.stream, idx,
                                      self.epoch))


class SyntheticFeatures:
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


class SyntheticAttrFeatures:
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


class CFGDataset:
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


class SyntheticT2IFeatures:
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


class SyntheticClassFeatures:
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


class _Factory:
    K: Optional[int] = None  # number of classes
    has_label = False
    fid_stat: Optional[str] = None  # FID reference statistics (.npz)

    def get_split(self, split: str = "train"):
        return getattr(self, split)


class Synthetic(_Factory):
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


class SyntheticAttr(_Factory):
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


class SyntheticT2I(_Factory):
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


class SyntheticClass(_Factory):
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


_REGISTRY = {"synthetic": Synthetic, "synthetic_attr": SyntheticAttr,
             "synthetic_t2i": SyntheticT2I, "synthetic_class": SyntheticClass}


def get_dataset(name: str, **kwargs):
    """A dataset by its config name: ``synthetic`` (the random moments a
    config trains on where its own features are not in the repository),
    ``synthetic_attr`` (attribute-structured moments), ``synthetic_t2i``
    (caption-structured moments and contexts) or ``synthetic_class``
    (class-structured moments and labels). ``fid_stat`` names the FID
    reference statistics of any of them (the training loop's in-loop FID).
    """
    if name not in _REGISTRY:
        raise NotImplementedError(f"dataset {name!r} is not ported")
    fid_stat = kwargs.pop("fid_stat", None)
    dataset = _REGISTRY[name](**kwargs)
    if fid_stat:
        dataset.fid_stat = fid_stat
    return dataset


def unpreprocess(images: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1], clipped (reference datasets.py:84-90)."""
    return np.clip((images + 1.0) / 2.0, 0.0, 1.0)
