"""Diagonal-covariance Gaussian mixture node model (counterpart of
``repro.core.gmm``): the log responsibilities the LMI search ranks
children with, so the port routes JAX-built gmm indexes. The EM fit is a
later slice (ROADMAP queue A)."""
from __future__ import annotations

import math

import torch

_LOG2PI = math.log(2.0 * math.pi)


def _estep_logprob(x, means, variances, log_weights):
    """(..., n, k) joint log prob  log w_k + log N(x_i | mu_k, var_k);
    means / variances may carry leading batch dims (..., k, d)."""
    inv = 1.0 / variances
    quad = ((x * x) @ inv.transpose(-1, -2)
            - 2.0 * (x @ (means * inv).transpose(-1, -2))
            + torch.sum(means * means * inv, dim=-1)[..., None, :])
    logdet = torch.sum(torch.log(variances), dim=-1)[..., None, :]
    d = x.shape[-1]
    return log_weights[..., None, :] - 0.5 * (d * _LOG2PI + logdet + quad)


def predict_log_proba(means, variances, log_weights, x, temperature: float = 1.0):
    """Normalised log responsibilities, log_softmax(logp / T); params may
    carry leading batch dims."""
    logp = _estep_logprob(x.float(), means, variances, log_weights)
    return torch.log_softmax(logp / temperature, dim=-1)
