"""Plain PyTorch version of the pairwise_l2 kernel.

Mirrors ``repro.kernels.pairwise_l2.ref.pairwise_l2_ref``: the direct
``sum((x - y)^2)`` in float32, the straightforward oracle the kernel's
norm decomposition is held against. Rows of x are taken ``block`` at a
time, so the (n, m, d) differences never exist at once.
"""
from __future__ import annotations

import torch


def pairwise_l2_ref(x: torch.Tensor, y: torch.Tensor, block: int = 16) -> torch.Tensor:
    """x (n, d), y (m, d) -> (n, m) float32 squared Euclidean distances."""
    x, y = x.float(), y.float()
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], block):
        diff = x[i:i + block, None, :] - y[None, :, :]
        out[i:i + block] = torch.sum(diff * diff, dim=-1)
    return out
