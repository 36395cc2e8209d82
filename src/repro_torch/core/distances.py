"""Vector distances of the pipeline (counterpart of ``repro.core.distances``).

The cheap distances the paper substitutes for the structural Q-score:
squared / plain Euclidean and cosine distance over the compact protein
embeddings. The pairwise forms use the ``|x|^2 + |y|^2 - 2 x.y``
decomposition, so the dominant cost is one matrix product (full float32:
TF32 is off, see ``repro_torch``).
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def pairwise_sq_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2: x (n, d), y (m, d) -> (n, m), clamped at 0
    to remove the small negatives of cancellation."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    yn = torch.sum(y * y, dim=-1)[None, :]
    xy = x.float() @ y.float().T
    return torch.clamp(xn + yn - 2.0 * xy, min=0.0)


def pairwise_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(pairwise_sq_euclidean(x, y))


def pairwise_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All-pairs cosine distance: x (n, d), y (m, d) -> (n, m)."""
    xn = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=_EPS)
    yn = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
    return 1.0 - xn @ yn.T


PAIRWISE = {
    "euclidean": pairwise_euclidean,
    "sq_euclidean": pairwise_sq_euclidean,
    "cosine": pairwise_cosine,
}


def get_pairwise(name: str):
    try:
        return PAIRWISE[name]
    except KeyError:
        raise ValueError(
            f"unknown distance {name!r}; available: {sorted(PAIRWISE)}"
        ) from None
