"""The paper's protein embedding, step (i) (counterpart of
``repro.core.embedding``).

Per chain: split its C-alpha trace into ``n_sections`` consecutive
sections of (nearly) equal length, average each section, take the
pairwise distances between the section centroids, clamp them at
``cutoff`` and divide by it, and keep the strict upper triangle
(N(N-1)/2 values; 10 sections -> 45 dims). A batch is a padded
(B, L_max, 3) array plus (B,) true lengths; the JAX package ``vmap``s one
chain, here the batch dimension is written out and runs on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


class EmbeddingConfig(NamedTuple):
    n_sections: int = 10
    cutoff: float = 50.0  # Angstrom-scale prune threshold

    @property
    def dim(self) -> int:
        n = self.n_sections
        return n * (n - 1) // 2


def section_means(coords: torch.Tensor, lengths: torch.Tensor, n_sections: int) -> torch.Tensor:
    """(B, L_max, 3), (B,) -> (B, n_sections, 3) section centroids.

    Residue ``pos`` of a chain of length ``n`` is in section
    ``floor(pos * n_sections / n)``; padding is masked out. A one-hot
    membership product, as in JAX, so there is no ragged shape."""
    n_res = coords.shape[1]
    pos = torch.arange(n_res, device=coords.device)
    lengths = lengths.long()
    valid = pos[None, :] < lengths[:, None]  # (B, L)
    sec = torch.div(pos[None, :] * n_sections, torch.clamp(lengths, min=1)[:, None],
                    rounding_mode="floor")
    sec = torch.clamp(sec, 0, n_sections - 1)
    onehot = (sec[:, None, :] == torch.arange(n_sections, device=coords.device)[None, :, None])
    onehot = (onehot & valid[:, None, :]).to(coords.dtype)  # (B, N, L)
    sums = onehot @ coords  # (B, N, 3)
    counts = torch.sum(onehot, dim=2, keepdim=True)
    return sums / torch.clamp(counts, min=1.0)


def embed_batch(coords: torch.Tensor, lengths: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Embed a padded batch: (B, L_max, 3), (B,) -> (B, N(N-1)/2) in [0, 1]."""
    cent = section_means(coords.float(), lengths, cfg.n_sections)  # (B, N, 3)
    diff = cent[:, :, None, :] - cent[:, None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
    dist = torch.clamp(dist, max=cfg.cutoff) / cfg.cutoff
    iu = torch.triu_indices(cfg.n_sections, cfg.n_sections, offset=1, device=coords.device)
    return dist[:, iu[0], iu[1]]  # row-major strict upper triangle, as jnp.triu_indices


def embed_dataset(coords, lengths, cfg: EmbeddingConfig, batch_size: int = 4096,
                  device=None) -> torch.Tensor:
    """Embed a host dataset (numpy or tensors) in chunks on ``device``
    (default: the card) -> (M, dim) float32 on that device."""
    dev = resolve_device(device)
    outs = []
    for s in range(0, coords.shape[0], batch_size):
        c = torch.as_tensor(np.asarray(coords[s:s + batch_size])).to(dev)
        n = torch.as_tensor(np.asarray(lengths[s:s + batch_size])).to(dev)
        outs.append(embed_batch(c, n, cfg))
    if not outs:
        return torch.zeros((0, cfg.dim), device=dev)
    return torch.cat(outs, dim=0)
