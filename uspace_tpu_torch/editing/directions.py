"""Semantic-direction builders: attribute deltas and per-time PCA.

Counterpart of ``uspace_tpu/editing/directions.py`` (the reference's
``tools/utils_attr.py`` mean-difference directions and
``tools/utils_pca.py`` per-timestep PCA), as batched tensor operations over
the in-memory capture stacks of :mod:`.capture`.

Shapes: ``feats`` is [N, T, ...feature] (N samples, T grid times); the
results are per-time grids [T, A, ...] / [T, K, ...], of which one row is
a :class:`~.specs.USpaceEdit` delta grid.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

# the attribute vocabularies (tools/utils_attr.py:15-90: CelebA's 40 and
# FFHQ's 11 emotion labels)
CELEBA_ATTR40 = (
    "5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs "
    "Big_Lips Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair "
    "Bushy_Eyebrows Chubby Double_Chin Eyeglasses Goatee Gray_Hair "
    "Heavy_Makeup High_Cheekbones Male Mouth_Slightly_Open Mustache "
    "Narrow_Eyes No_Beard Oval_Face Pale_Skin Pointy_Nose Receding_Hairline "
    "Rosy_Cheeks Sideburns Smiling Straight_Hair Wavy_Hair Wearing_Earrings "
    "Wearing_Hat Wearing_Lipstick Wearing_Necklace Wearing_Necktie Young"
).split()
FFHQ_ATTR11 = ["gender", "smile", "no_glasses", "anger", "contempt",
               "disgust", "fear", "happiness", "neutral", "sadness",
               "surprise"]


def attr_name(attr_id: int, num_attrs: int) -> str:
    """The name of attribute ``attr_id`` in the vocabulary of
    ``num_attrs`` (40: CelebA, 11: FFHQ), else ``attr_<id>``."""
    vocab = {40: CELEBA_ATTR40, 11: FFHQ_ATTR11}.get(num_attrs)
    return vocab[attr_id] if vocab else f"attr_{attr_id}"


def attr_delta(feats: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """``mean(feats | attr = 1) - mean(feats | attr = 0)`` for one binary
    attribute: feats [N, ...], attr [N] in {0, 1} -> [...] (the reference's
    ``cal_delta_direction``)."""
    attr = attr.to(torch.float32)
    w_pos = attr / torch.clamp(attr.sum(), min=1.0)
    w_neg = (1.0 - attr) / torch.clamp((1.0 - attr).sum(), min=1.0)
    shape = (-1,) + (1,) * (feats.ndim - 1)
    pos = (feats * w_pos.reshape(shape)).sum(dim=0)
    neg = (feats * w_neg.reshape(shape)).sum(dim=0)
    return pos - neg


def attr_delta_directions(feats: torch.Tensor,
                          attrs: torch.Tensor) -> torch.Tensor:
    """Every attribute at every time: feats [N, T, ...], attrs [N, A] ->
    the [T, A, ...] delta grid (the reference's per-timestep
    ``delta_{t:.2f}.npy`` files)."""
    deltas = torch.stack([attr_delta(feats, attrs[:, a])
                          for a in range(attrs.shape[1])])
    return deltas.transpose(0, 1)


def latentz_delta(latents: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
    """z-space (x0) directions: [N, ...], [N, A] -> [A, ...] (the
    reference's ``cal_latentz_delta``)."""
    return torch.stack([attr_delta(latents, attrs[:, a])
                        for a in range(attrs.shape[1])])


def pca_components(feats: torch.Tensor, n_components: int,
                   center: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k PCA directions of the flattened features: feats [N, ...] ->
    (components [K, ...], explained variance [K]), by SVD of the centred
    data matrix. A component's sign is the SVD's, which another library may
    flip."""
    n = feats.shape[0]
    flat = feats.reshape(n, -1).to(torch.float32)
    if center:
        flat = flat - flat.mean(dim=0, keepdim=True)
    _, s, vt = torch.linalg.svd(flat, full_matrices=False)
    comps = vt[:n_components].reshape((n_components,) + feats.shape[1:])
    var = s[:n_components] ** 2 / max(n - 1, 1)
    return comps, var


def pca_directions(feats: torch.Tensor, n_components: int) -> torch.Tensor:
    """Per-time PCA: feats [N, T, ...] -> the [T, K, ...] grid (the
    reference's ``pca{n}_{t:.2f}.npy`` files)."""
    return torch.stack([pca_components(feats[:, i], n_components)[0]
                        for i in range(feats.shape[1])])


def orthogonality_error(components: torch.Tensor) -> float:
    """max |<c_i, c_j>| off the diagonal of the normalised components: the
    reference's PCA sanity check."""
    k = components.shape[0]
    flat = components.reshape(k, -1)
    flat = flat / torch.linalg.norm(flat, dim=1, keepdim=True)
    g = flat @ flat.T - torch.eye(k, dtype=flat.dtype, device=flat.device)
    return float(g.abs().max())


def select_direction(grid: torch.Tensor,
                     ith: Union[int, str]) -> torch.Tensor:
    """One direction row of a [T, A, ...] grid: an int picks that row,
    "31_39_20" averages the listed rows (the reference's multi-attribute
    averaging). Returns the [T, ...] delta grid of a USpaceEdit."""
    if isinstance(ith, str):
        ids = [int(tok) for tok in ith.split("_")]
        return torch.stack([grid[:, i] for i in ids]).mean(dim=0)
    return grid[:, int(ith)]
