"""Plain PyTorch version of the kmeans_assign kernel.

Mirrors the kernel's arithmetic (the TPU kernel's, too): the norm
decomposition clamped at 0, argmin ties to the lowest index
(`torch.argmin` returns the first minimum, as `jnp.argmin` does).
Takes a leading group dim like the kernel: x (..., n, d), centroids
(..., k, d).
"""
from __future__ import annotations

import torch


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor):
    """-> (labels (..., n) int32, min_d2 (..., n) float32)."""
    x = x.float()
    c = centroids.float()
    xn = torch.sum(x * x, dim=-1)[..., :, None]
    cn = torch.sum(c * c, dim=-1)[..., None, :]
    d2 = torch.clamp(xn + cn - 2.0 * (x @ c.transpose(-1, -2)), min=0.0)
    mind, labels = torch.min(d2, dim=-1)
    return labels.to(torch.int32), mind
