"""K-Means, the LMI's default partitioning model (counterpart of
``repro.core.kmeans``).

  * k-means++ initialisation (weighted D^2 sampling, by an inverse CDF
    summed in a fixed order);
  * Lloyd iterations until the centroid shift drops to ``tol``;
  * per-point weights (weight 0 == padding), so the variable-size child
    fits of every LMI level >= 1 run as one padded batch (`fit_many`);
  * per-cluster sums by a one-hot product, as the reference takes them,
    so a build on the card reproduces from its seed;
  * empty-cluster repair: an empty centroid snaps to the live point
    farthest from its centroid (``argmax(mind2 * weights)``);
  * `predict_log_proba` — log_softmax over negative squared distances,
    the node model of the LMI search.

Every Lloyd assignment goes through `repro_torch.kernels.kmeans_assign`:
on CUDA tensors that is the hand-written kernel, on CPU tensors its plain
version. The groups of `fit_many` share one launch per iteration.

Random numbers come from a `torch.Generator`; they differ from
``jax.random``'s, so a port build and a JAX build of the same data fit
different (equally good) centroids. `fit` / `fit_many` take
``init_centroids`` to start both from the same seeds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.kmeans_assign import ops as ka_ops


class KMeansState(NamedTuple):
    centroids: torch.Tensor  # (k, d), or (G, k, d) from fit_many
    inertia: torch.Tensor  # weighted sum of squared distances
    n_iter: torch.Tensor  # Lloyd steps taken


_SCAN_BLOCK = 512  # entries of a row the CDF sums in one scan


def _cdf(p: torch.Tensor) -> torch.Tensor:
    """The inclusive cumulative sum of ``p`` (..., n) over its last dim,
    added in the same order on every run: scans within blocks of
    ``_SCAN_BLOCK`` entries, then the blocks' totals before each block by a
    product with a triangular matrix. (torch.cumsum of a single long row on
    CUDA scans with a look-back across thread blocks, whose float order,
    and so the seeding's draws, change from run to run.)

    The scans and the product add in different orders, so a block's first
    entry can round below the previous block's last; a running maximum
    (exact, so the same in any order) makes the CDF non-decreasing, and an
    entry of no mass is then never drawn."""
    n = p.shape[-1]
    m = -(-n // _SCAN_BLOCK)
    blocks = F.pad(p, (0, m * _SCAN_BLOCK - n)).reshape(*p.shape[:-1], m, _SCAN_BLOCK)
    within = torch.cumsum(blocks, dim=-1)
    earlier = torch.ones((m, m), dtype=p.dtype, device=p.device).triu(1)  # [i, j] = i < j
    before = within[..., -1] @ earlier  # (..., m): the totals of the blocks before each
    cdf = torch.cummax(within + before[..., None], dim=-1).values
    carry = torch.cummax(cdf[..., -1], dim=-1).values  # (..., m): the max up to each block
    carry = F.pad(carry[..., :-1], (1, 0))  # ... before each block (p >= 0: 0 before the first)
    cdf = torch.maximum(cdf, carry[..., None])
    return cdf.reshape(*p.shape[:-1], m * _SCAN_BLOCK)[..., :n].contiguous()


def _choice(gen: torch.Generator, p: torch.Tensor) -> torch.Tensor:
    """One index per row drawn with probabilities proportional to ``p``
    (..., n) — the inverse-CDF rule of ``jax.random.choice(p=...)``: an
    all-zero row draws index 0."""
    cdf = _cdf(p)
    u = torch.rand(p.shape[:-1], generator=gen, device=p.device, dtype=p.dtype)
    r = cdf[..., -1] * (1.0 - u)
    idx = torch.searchsorted(cdf, r[..., None].contiguous())[..., 0]
    return torch.clamp(idx, max=p.shape[-1] - 1)


def _plusplus_init(gen: torch.Generator, x: torch.Tensor, k: int,
                   weights: torch.Tensor) -> torch.Tensor:
    """k-means++ (weighted D^2) seeding; x (..., n, d), weights (..., n)
    -> (..., k, d). Leading dims are independent groups."""
    def take(idx):  # (...,) -> (..., 1, d)
        return torch.gather(x, -2, idx[..., None, None].expand(*idx.shape, 1, x.shape[-1]))

    probs = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    c = take(_choice(gen, probs))
    cents = [c]
    d2 = torch.sum((x - c) ** 2, dim=-1)
    for _ in range(1, k):
        scores = d2 * weights
        probs = scores / torch.clamp(torch.sum(scores, dim=-1, keepdim=True), min=1e-12)
        c = take(_choice(gen, probs))
        cents.append(c)
        d2 = torch.minimum(d2, torch.sum((x - c) ** 2, dim=-1))
    return torch.cat(cents, dim=-2)


def assign(x: torch.Tensor, centroids: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Hard assignment: (n,) int32 cluster ids.

    ``use_kernel`` is kept for the JAX signature: on CUDA tensors the
    hand-written kmeans_assign kernel always runs, on CPU tensors the
    plain norm-decomposition argmin (ties to the lowest index)."""
    del use_kernel
    return ka_ops.kmeans_assign(x.float(), centroids.float())


def _lloyd_step_many(x: torch.Tensor, centroids: torch.Tensor, k: int,
                     weights: torch.Tensor):
    """One Lloyd step for G groups at once: x (G, n, d), centroids
    (G, k, d), weights (G, n) -> (new centroids, labels, inertia (G,))."""
    d = x.shape[-1]
    labels, mind2 = ka_ops.kmeans_assign_with_dist(x, centroids)
    inertia = torch.sum(mind2 * weights, dim=-1)
    # per-cluster sums as the reference takes them, onehot.T @ x: a product
    # and a reduction, whose results do not depend on any run-time order
    # (a scatter-add adds by atomics on the card, so the build would not
    # reproduce from its seed); the product runs in full float32. onehot
    # (G, n, k) is one_hot(labels, k) * weights, built without an int64 copy
    ids = torch.arange(k, device=x.device, dtype=labels.dtype)
    onehot = torch.where(labels[..., None] == ids, weights[..., None], 0.0)
    counts = onehot.sum(1)
    sums = torch.bmm(onehot.transpose(1, 2), x)
    new = sums / torch.clamp(counts, min=1e-12)[..., None]
    # empty-cluster repair: the live point farthest from its centroid
    # (weight-masked, so padding is never chosen; argmax ties to the first)
    far = torch.argmax(mind2 * weights, dim=-1)
    farthest = torch.gather(x, 1, far[:, None, None].expand(-1, 1, d))
    new = torch.where((counts < 1e-12)[..., None], farthest, new)
    return new, labels, inertia


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, k: int, weights: torch.Tensor):
    """One Lloyd step: x (n, d) -> (new centroids (k, d), labels (n,), inertia)."""
    new, labels, inertia = _lloyd_step_many(x[None], centroids[None], k, weights[None])
    return new[0], labels[0], inertia[0]


def _lloyd(x, c, k, w, max_iter: int, tol: float):
    """Batched Lloyd loop over G groups. Each group freezes once its own
    shift is <= tol (or it reached max_iter) while the others go on —
    what ``vmap`` of the JAX ``while_loop`` does."""
    g = x.shape[0]
    shift = torch.full((g,), float("inf"), device=x.device)
    it = torch.zeros((g,), dtype=torch.int32, device=x.device)
    inertia = torch.full((g,), float("inf"), device=x.device)
    active = (shift > tol) & (it < max_iter)
    while bool(active.any()):
        new_c, _, new_inertia = _lloyd_step_many(x, c, k, w)
        new_shift = torch.sqrt(torch.sum((new_c - c) ** 2, dim=(-2, -1)))
        c = torch.where(active[:, None, None], new_c, c)
        inertia = torch.where(active, new_inertia, inertia)
        shift = torch.where(active, new_shift, shift)
        it = it + active.to(torch.int32)
        active = (shift > tol) & (it < max_iter)
    return c, inertia, it


def fit(gen: torch.Generator, x: torch.Tensor, k: int,
        weights: Optional[torch.Tensor] = None, max_iter: int = 50, tol: float = 1e-4,
        init_centroids: Optional[torch.Tensor] = None) -> KMeansState:
    """Fit K-Means from k-means++ seeds. x (n, d) [+ (n,) weights] ->
    KMeansState. ``init_centroids`` (k, d) replaces the random seeding."""
    x = x.float()
    n = x.shape[0]
    w = torch.ones((n,), device=x.device) if weights is None else weights.float()
    c0 = _plusplus_init(gen, x, k, w) if init_centroids is None else init_centroids.float()
    c, inertia, it = _lloyd(x[None], c0[None], k, w[None], max_iter, tol)
    return KMeansState(centroids=c[0], inertia=inertia[0], n_iter=it[0])


def fit_many(gen: torch.Generator, xs: torch.Tensor, ws: torch.Tensor, k: int,
             max_iter: int = 25, tol: float = 1e-4,
             init_centroids: Optional[torch.Tensor] = None) -> KMeansState:
    """Fit one K-Means per padded group — one batched program.

    xs (G, cap, d) padded, ws (G, cap) 0/1 routing weights; used by every
    level >= 1 of the LMI build. Returns stacked KMeansState with a
    leading G dim."""
    xs = xs.float()
    ws = ws.float()
    c0 = (_plusplus_init(gen, xs, k, ws) if init_centroids is None
          else init_centroids.float())
    c, inertia, it = _lloyd(xs, c0, k, ws, max_iter, tol)
    return KMeansState(centroids=c, inertia=inertia, n_iter=it)


def predict(state: KMeansState, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    return assign(x.float(), state.centroids, use_kernel=use_kernel)


def predict_log_proba(centroids: torch.Tensor, x: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """Per-node log responsibilities: log_softmax(-d^2 / T).

    ``centroids`` may carry leading batch dims (..., k, d); x is (n, d)
    or batched to match; the result broadcasts to (..., n, k). Norm
    decomposition, so the inner loop is one full-float32 product.
    """
    xf = x.float()
    cf = centroids.float()
    xc = xf @ cf.transpose(-1, -2)  # (..., n, k)
    xn = torch.sum(xf * xf, dim=-1)[..., :, None]
    cn = torch.sum(cf * cf, dim=-1)[..., None, :]
    d2 = torch.clamp(xn + cn - 2.0 * xc, min=0.0)
    return torch.log_softmax(-d2 / temperature, dim=-1)
