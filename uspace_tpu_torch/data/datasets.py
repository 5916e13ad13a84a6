"""Feature datasets: the port's own copy of what its slices need from
``uspace_tpu/data/datasets.py`` (numpy only; the port imports nothing of
the JAX package), with the ``get_dataset`` factory of the synthetic
datasets (``synthetic``, ``synthetic_attr``). Batches come from
``data/loader.DataLoader``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


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


class _Factory:
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


_REGISTRY = {"synthetic": Synthetic, "synthetic_attr": SyntheticAttr}


def get_dataset(name: str, **kwargs):
    """A dataset by its config name: ``synthetic`` (the random moments a
    config trains on where its own features are not in the repository) or
    ``synthetic_attr`` (attribute-structured moments)."""
    if name not in _REGISTRY:
        raise NotImplementedError(f"dataset {name!r} is not ported")
    return _REGISTRY[name](**kwargs)


def unpreprocess(images: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1], clipped (reference datasets.py:84-90)."""
    return np.clip((images + 1.0) / 2.0, 0.0, 1.0)
