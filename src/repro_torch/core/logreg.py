"""Multinomial logistic-regression node model (counterpart of
``repro.core.logreg``): the log-probabilities the LMI search ranks
children with, so the port routes JAX-built kmeans+logreg indexes. The
fit is a later slice (ROADMAP queue A)."""
from __future__ import annotations

import torch


def predict_log_proba(weights, bias, x, temperature: float = 1.0):
    """log_softmax((x @ w + b) / T); weights may carry leading batch dims
    (..., d, k)."""
    logits = x.float() @ weights + bias[..., None, :]
    return torch.log_softmax(logits / temperature, dim=-1)
