"""Plain PyTorch version of the beam_eval kernel, plus the score math it
shares (counterpart of ``repro.kernels.beam_eval.ref``).

Given a batch of queries and, per query, a beam frontier of node ids into
one stacked level of node models, return the (Q, F, arity) child
log-probabilities: what `lmi.beam_leaf_ranking`'s gather path computes
with a per-pair parameter gather and the family's `predict_log_proba`.

The plain version materializes the per-pair parameter gather on purpose:
it is the straightforward reference the CUDA kernel is checked against,
on the CPU in the tests and on the card in chip_smoke.py.

Canonical planes (`ops.family_planes`): every family reduces to at most
two (N, arity, d) matrices (``mats[0]`` contracted with the query ``q``,
``mats[1]`` with ``q*q``) plus (N, arity) vector planes, combined with
the association order of the families' `predict_log_proba`:

  kmeans   mats=(centroids,)          vecs=(|c|^2,)
           score = -max((|q|^2 + |c|^2) - 2 q.c, 0)
  gmm      mats=(mu/var, 1/var)       vecs=(log_w, sum mu^2/var,
                                            d log 2pi + sum log var)
           score = log_w - 0.5*(vecs2 + ((q^2 . inv) - 2 (q . mu inv)
                                         + vecs1))
  logreg   mats=(w^T,)                vecs=(b,)
           score = q.w + b

followed by a row-wise log-softmax over the arity axis.
"""
from __future__ import annotations

import torch

FAMILIES = ("kmeans", "gmm", "kmeans+logreg")


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise log-softmax over the last axis, spelled like
    ``jax.nn.log_softmax``: max-shift, then log-sum-exp."""
    m = torch.amax(x, dim=-1, keepdim=True)
    shifted = x - m
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))


def combine_scores(model_type: str, dots, vecs, qn: torch.Tensor) -> torch.Tensor:
    """Pre-softmax child scores from the plane dot products.

    ``dots[m]`` is the (..., arity) contraction of the query (m=0) or the
    squared query (m=1) with ``mats[m]``; ``vecs`` are the gathered vector
    planes; ``qn`` is |q|^2, broadcastable to (..., 1)."""
    if model_type == "kmeans":
        return -torch.clamp((qn + vecs[0]) - 2.0 * dots[0], min=0.0)
    if model_type == "gmm":
        quad = dots[1] - 2.0 * dots[0] + vecs[1]
        return vecs[0] - 0.5 * (vecs[2] + quad)
    if model_type == "kmeans+logreg":
        return dots[0] + vecs[0]
    raise ValueError(f"unknown model_type {model_type!r}")


def node_scores_ref(queries: torch.Tensor, prefix: torch.Tensor, planes,
                    model_type: str) -> torch.Tensor:
    """(Q, F, arity) child log-probs by per-pair gather.

    queries (Q, d) f32; prefix (Q, F) int node ids into the planes'
    leading N axis. Materializes the (Q, F, arity, d) parameter gather."""
    q = queries.float()
    p = prefix.long()
    xs = (q, q * q)
    dots = tuple(torch.einsum("qd,qfad->qfa", xs[m], planes.mats[m][p])
                 for m in range(len(planes.mats)))
    vecs = tuple(v[p] for v in planes.vecs)
    qn = torch.sum(q * q, dim=-1)[:, None, None]
    return log_softmax(combine_scores(model_type, dots, vecs, qn))
