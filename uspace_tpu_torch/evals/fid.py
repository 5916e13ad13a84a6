"""Fréchet Inception Distance, the pytorch-fid protocol (counterpart of
``uspace_tpu/evals/fid.py``).

InceptionV3 pool3 activations (``evals/inception``), (mu, sigma) Gaussian
statistics with ``.npz`` caching in pytorch-fid's ``{mu, sigma}`` key
format, and the Fréchet distance with the reference's sqrtm stabilization
(`tools/fid_score.py:132-186`). Activations are computed on the device in
batches; the 2048 x 2048 sqrtm runs on the host through scipy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..codecs.convert import load_torch_checkpoint
from .inception import InceptionV3, load_pytorch_fid_state_dict

DEFAULT_WEIGHTS = "assets/fid/pt_inception-2015-12-05.pth"
# the seed of the "random" featurizer's weights
RANDOM_SEED = 0


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))
    (reference calculate_frechet_distance, fid_score.py:132-186,
    including the eps-jitter retry and imaginary-part check)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


class InceptionFeaturizer:
    """Batched pool3 activation extractor on ``device`` (CUDA unless
    "cpu"). ``weights_path``: a pytorch-fid ``.pth`` (default
    :data:`DEFAULT_WEIGHTS`), or "random" for seeded random weights, which
    let the whole sample -> decode -> featurize -> Fréchet -> best-checkpoint
    pipeline run where the pytorch-fid file is absent (the FID value is then
    meaningless; the pipeline is not)."""

    def __init__(self, weights_path: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        path = weights_path or DEFAULT_WEIGHTS
        if path != "random" and not os.path.exists(path):
            raise FileNotFoundError(
                f"Inception weights not found at {path}; download "
                "pt_inception-2015-12-05 (pytorch-fid) and point "
                "weights_path at it.")
        # built and seeded on the CPU, then moved: the "random" weights
        # are the same on every device
        self.model = InceptionV3()
        if path == "random":
            self.model.init_weights(torch.Generator().manual_seed(RANDOM_SEED))
        else:
            load_pytorch_fid_state_dict(self.model,
                                        load_torch_checkpoint(path))
        self.model.to(self.device)

    @torch.no_grad()
    def _run(self, batch) -> np.ndarray:
        x = torch.from_numpy(np.stack(batch)).to(self.device)
        return self.model(x).cpu().numpy()

    def __call__(self, images01, batch_size: int = 50) -> np.ndarray:
        """images01: [N, H, W, 3] float in [0, 1] (an array or a lazy
        per-image iterable of [H, W, 3]) -> [N, 2048] f32."""
        outs, batch = [], []
        for img in images01:
            batch.append(np.asarray(img, np.float32))
            if len(batch) == batch_size:
                outs.append(self._run(batch))
                batch = []
        if batch:
            outs.append(self._run(batch))
        return np.concatenate(outs)


def _iter_images_from_dir(path: str):
    """Lazy per-image loader: a 50k-image FID evaluation must not hold
    ~39 GB of pixels in host memory at once."""
    from PIL import Image

    exts = (".png", ".jpg", ".jpeg", ".bmp")
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(exts))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    for f in files:
        yield np.asarray(Image.open(os.path.join(path, f)).convert("RGB"),
                         np.float32) / 255.0


def compute_statistics_of_path(
    path: str, featurizer: Optional[InceptionFeaturizer] = None,
    batch_size: int = 50,
) -> Tuple[np.ndarray, np.ndarray]:
    """A ``.npz`` statistics file (mu / sigma keys, pytorch-fid format) or
    an image directory (reference fid_score.py:214-225)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    feat = featurizer or InceptionFeaturizer()
    acts = feat(_iter_images_from_dir(path), batch_size)
    return activation_statistics(acts)


def save_statistics_of_path(path: str, out_npz: str,
                            featurizer=None, batch_size: int = 50) -> None:
    """Precompute a dataset's statistics (reference save_statistics_of_path,
    fid_score.py:228-236)."""
    mu, sigma = compute_statistics_of_path(path, featurizer, batch_size)
    np.savez(out_npz, mu=mu, sigma=sigma)


def fid_given_paths(path1: str, path2: str,
                    weights_path: Optional[str] = None,
                    batch_size: int = 50, device=None) -> float:
    """FID between two paths (statistics ``.npz`` or image directories),
    reference calculate_fid_given_paths (fid_score.py:239-260); the
    featurizer on ``device`` (CUDA unless "cpu")."""
    feat = None
    if not (path1.endswith(".npz") and path2.endswith(".npz")):
        feat = InceptionFeaturizer(weights_path, device)
    m1, s1 = compute_statistics_of_path(path1, feat, batch_size)
    m2, s2 = compute_statistics_of_path(path2, feat, batch_size)
    return frechet_distance(m1, s1, m2, s2)
