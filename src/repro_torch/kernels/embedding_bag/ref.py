"""Plain PyTorch version of the embedding_bag kernel.

Mirrors ``repro.kernels.embedding_bag.ref.embedding_bag_ref`` (gather,
weight, sum over the bag; ``mode="mean"`` divides by the weight sum, or
by L without weights) in float32. As in the kernel (and in the TPU
kernel, whose multi-hot lanes an out-of-range id never matches), an id
outside [0, V) adds nothing.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None = None,
                      mode: str = "sum") -> torch.Tensor:
    """table (V, D), ids (B, L), weights (B, L) or None -> (B, D) float32."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    ids = ids.long()
    ok = (ids >= 0) & (ids < table.shape[0])
    w = torch.ones(ids.shape, dtype=torch.float32, device=ids.device) if weights is None \
        else weights.float()
    emb = table[torch.where(ok, ids, 0)].float()  # (B, L, D)
    out = torch.sum(emb * torch.where(ok, w, 0.0)[..., None], dim=1)
    return bag_mean(out, ids, weights) if mode == "mean" else out


def bag_mean(sums: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """``mode="mean"`` from the bag sums: divide by the weight sum, or by
    L without weights, floored at 1e-9 (JAX's ``ops.embedding_bag``)."""
    denom = (weights.float().sum(dim=1, keepdim=True) if weights is not None
             else torch.full((ids.shape[0], 1), float(ids.shape[1]), device=ids.device))
    return sums / torch.clamp(denom, min=1e-9)
