"""Embedding substrate of the recsys models (counterpart of the first part
of ``repro.models.recsys``): one fused table for every sparse field with
per-field row offsets, single-hot lookups and multi-hot bags.

``bag_lookup(use_kernel=True)`` goes through the embedding-bag kernel
(`repro_torch.kernels.embedding_bag`); the plain form is the gather and
sum JAX writes. The models themselves (Wide&Deep, xDeepFM, MIND, DLRM)
are not ported yet (ROADMAP.md, 'Next').
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.embedding_bag import ops as eb_ops


def field_offsets(vocab_sizes: Sequence[int]) -> torch.Tensor:
    """Per-field row offsets into the fused table, int32."""
    return torch.from_numpy(np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32))


def init_tables(seed: int, vocab_sizes: Sequence[int], dim: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Fused per-field embedding tables -> one (rows, dim) weight, normal x
    ``dim**-0.5`` as in JAX. Rows are padded to a multiple of 512 (JAX pads
    so that the table row-shards evenly); padded rows are never indexed.
    Drawn on the device from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    total = int(sum(vocab_sizes))
    padded = ((total + 511) // 512) * 512
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn((padded, dim), generator=gen, device=dev, dtype=torch.float32)
    return t.mul_(dim ** -0.5).to(dtype)


def lookup(weight: torch.Tensor, vocab_sizes: Sequence[int], ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F), one id per field -> (B, F, dim)."""
    rows = ids.long() + field_offsets(vocab_sizes).to(ids.device).long()[None, :]
    return weight[rows]


def bag_lookup(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None = None,
               use_kernel: bool = False) -> torch.Tensor:
    """Multi-hot bag: table (V, D), ids (B, L) -> (B, D) sum-reduced."""
    if use_kernel:
        return eb_ops.embedding_bag(table, ids, weights)
    emb = table[ids.long()]
    if weights is not None:
        emb = emb * weights[..., None]
    return torch.sum(emb, dim=1)
