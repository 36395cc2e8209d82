"""Plain PyTorch version of the lmi_filter kernels (counterpart of
``repro.kernels.lmi_filter.ref``).

Materializes the (Q, C, d) candidate gather on purpose: it is the
straightforward reference the fused kernels are checked against, on the
CPU in the tests and on the card in chip_smoke.py. Distances depend only
on rows / valid, so one reference covers the row and the descriptor
gathers alike.
"""
from __future__ import annotations

import torch

_BIG = 3.4e38
_EPS = 1e-12


def lmi_filter_ref(queries, rows, valid, embeddings, metric: str = "euclidean",
                   scales=None):
    """(Q, C) candidate distances; invalid slots get +_BIG.

    queries (Q, d), rows (Q, C) int indices into embeddings (M, d)
    [f32/bf16 + optional (M,) scales], valid (Q, C) bool.
    """
    from repro_torch.core.store import gather_dequant

    q = queries.float()
    cand = gather_dequant(embeddings, scales, rows.long())  # (Q, C, d)
    qb = q[:, None, :]
    if metric == "euclidean":
        d = torch.sqrt(torch.clamp(torch.sum((cand - qb) ** 2, dim=-1), min=0.0))
    elif metric == "sq_euclidean":
        d = torch.sum((cand - qb) ** 2, dim=-1)
    elif metric == "cosine":
        num = torch.sum(cand * qb, dim=-1)
        den = torch.linalg.norm(cand, dim=-1) * torch.linalg.norm(qb, dim=-1)
        d = 1.0 - num / torch.clamp(den, min=_EPS)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(valid, d, torch.full_like(d, _BIG))


def lmi_filter_topk_ref(queries, rows, valid, embeddings, k: int,
                        metric: str = "euclidean", scales=None):
    """Top-k smallest candidate distances: -> (dist (Q, k), slot (Q, k) int32).

    A stable ascending sort, so ties go to the lowest slot as with
    `jax.lax.top_k` (never a bare `torch.topk`, whose tie order is
    unspecified). Exhausted slots hold +_BIG and whichever invalid slot
    sorted there (callers mask on distance).
    """
    d = lmi_filter_ref(queries, rows, valid, embeddings, metric=metric, scales=scales)
    dist, slot = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], slot[:, :k].to(torch.int32)
