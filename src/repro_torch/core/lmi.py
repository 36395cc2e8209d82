"""Learned Metric Index (LMI) — counterpart of ``repro.core.lmi``.

The index is a level stack of learned partitioning models: level 0 is
one model of arity ``a0`` fit on the whole dataset; level ``i`` is a
stack of ``prod(arities[:i])`` node models of arity ``a_i``, each fit on
the points routed to its parent. Leaf ids are mixed-radix prefixes. The
paper's best setup is the 2-level (256, 64) K-Means stack.

Search: the joint leaf log-probability factorises over the levels, so
one batched evaluation per level gives the dense (Q, n_leaves) panel
(`leaf_log_probs`, exact enumeration); or a beam keeps only the best
prefixes before each expansion and scores only their children
(`beam_leaf_ranking`, per-pair gather or the segmented beam_eval
kernel). Leaves are ranked best-first and the ranked bucket stream is
cut at the stop condition (`rank_visited_buckets` /
`beam_rank_visited_buckets`); `extract_rows` turns the visited
buckets into a fixed-shape (Q, cap) CSR-row matrix plus validity, and
`BucketRuns` describes the same candidates as contiguous runs — what the
CUDA filter kernel gathers by.

Ties follow JAX: ``jnp.argsort`` / ``jax.lax.top_k`` put equal keys in
index order, so every ranking here is a stable sort
(``torch.sort(..., stable=True)``), never a bare ``torch.topk``. Public
index outputs stay int32, as in JAX; the cumulative sums inside run in
int64.

The query path needs no host sync per query: the candidate capacity
comes from the build-time ``max_bucket_size`` (`query_plan_params`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gmm, kmeans, logreg
from repro_torch.kernels.beam_eval import ops as be_ops

MODEL_TYPES = ("kmeans", "gmm", "kmeans+logreg")
NODE_EVAL_MODES = ("gather", "segmented")


def normalize_beam_widths(beam_width, depth: int):
    """Canonical per-level width schedule: None, or a tuple of
    ``depth - 1`` ints."""
    if beam_width is None:
        return None
    if isinstance(beam_width, (int, np.integer)):
        if beam_width < 1:
            raise ValueError(f"beam_width must be >= 1, got {beam_width}")
        return (int(beam_width),) * max(depth - 1, 0)
    widths = tuple(int(b) for b in beam_width)
    if len(widths) != depth - 1:
        raise ValueError(
            f"beam width schedule must have depth - 1 = {depth - 1} entries "
            f"(one per pruned expansion), got {len(widths)}: {widths}"
        )
    if any(b < 1 for b in widths):
        raise ValueError(f"beam widths must be >= 1, got {widths}")
    return widths


def normalize_temperatures(temperatures, depth: int) -> tuple:
    """Canonical per-level temperatures: ``depth`` floats (None == 1.0)."""
    if temperatures is None:
        return (1.0,) * depth
    if isinstance(temperatures, (int, float, np.floating, np.integer)):
        temperatures = (float(temperatures),) * depth
    temps = tuple(float(t) for t in temperatures)
    if len(temps) != depth:
        raise ValueError(
            f"temperatures must have one entry per level ({depth}), got "
            f"{len(temps)}: {temps}"
        )
    if any(t <= 0.0 for t in temps):
        raise ValueError(f"temperatures must be > 0, got {temps}")
    return temps


@dataclasses.dataclass(frozen=True)
class LMI:
    """A built learned metric index of arbitrary depth.

    ``levels[i]`` maps parameter names to tensors: level 0 is one model,
    level ``i >= 1`` has a leading ``prod(arities[:i])`` node dim.
    ``bucket_offsets`` / ``sorted_ids`` / ``sorted_embeddings`` form the
    CSR bucket store: bucket ``b`` holds rows
    ``sorted_*[bucket_offsets[b] : bucket_offsets[b+1]]``.
    """

    arities: tuple
    model_type: str
    levels: tuple  # of dict[str, Tensor]
    bucket_offsets: torch.Tensor  # (n_leaves + 1,) int32
    sorted_ids: torch.Tensor  # (M,) int32
    sorted_embeddings: torch.Tensor  # (M, d) float32
    max_bucket_size: int = 0
    index_revision: int = 0

    @property
    def depth(self) -> int:
        return len(self.arities)

    @property
    def n_leaves(self) -> int:
        return math.prod(self.arities)

    @property
    def n_objects(self) -> int:
        return self.sorted_ids.shape[0]

    @property
    def dim(self) -> int:
        return self.sorted_embeddings.shape[1]

    @property
    def device(self) -> torch.device:
        return self.sorted_embeddings.device

    def bucket_sizes(self) -> torch.Tensor:
        return self.bucket_offsets[1:] - self.bucket_offsets[:-1]

    def memory_bytes(self, include_data: bool = False) -> int:
        """Index-structure footprint (paper Table 3 'index size')."""
        n = sum(t.numel() * t.element_size() for lv in self.levels for t in lv.values())
        n += self.bucket_offsets.numel() * 4 + self.sorted_ids.numel() * 4
        if include_data:
            n += self.sorted_embeddings.numel() * self.sorted_embeddings.element_size()
        return n

    def to(self, device) -> "LMI":
        """The same index with every tensor on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(
            self,
            levels=tuple({k: v.to(device) for k, v in lv.items()} for lv in self.levels),
            bucket_offsets=self.bucket_offsets.to(device),
            sorted_ids=self.sorted_ids.to(device),
            sorted_embeddings=self.sorted_embeddings.to(device),
        )


# --------------------------------------------------------------------- build


def _node_log_proba(model_type: str, params: dict, x: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Child log-probabilities for one level; params may carry leading
    node dims -> (..., n, arity)."""
    if model_type == "kmeans":
        return kmeans.predict_log_proba(params["centroids"], x, temperature=temperature)
    if model_type == "gmm":
        return gmm.predict_log_proba(params["means"], params["variances"],
                                     params["log_weights"], x, temperature=temperature)
    if model_type == "kmeans+logreg":
        return logreg.predict_log_proba(params["w"], params["b"], x, temperature=temperature)
    raise ValueError(f"unknown model_type {model_type!r}")


def _require_kmeans(model_type: str) -> None:
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type must be one of {MODEL_TYPES}")
    if model_type != "kmeans":
        raise NotImplementedError(
            f"building a {model_type!r} index is not ported yet (ROADMAP queue A: "
            "gmm / logreg fits); the port routes JAX-built indexes of every family")


def _pad_groups(x: torch.Tensor, labels: np.ndarray, n_groups: int,
                group_cap: Optional[int], min_k: int):
    """Route points into fixed-size per-parent groups for the batched fit.

    -> (xs (n_groups, cap, d), ws (n_groups, cap)) with 0/1 routing
    weights (weight 0 == padding). Groups larger than ``cap`` are
    truncated (weight-masked). The cap is rounded up to a multiple of
    128, as in the JAX build, so both fit the same padded shapes.
    """
    counts = np.bincount(labels, minlength=n_groups)
    cap = int(group_cap or max(int(counts.max()), min_k))
    cap = max(128, ((cap + 127) // 128) * 128)
    order = np.argsort(labels, kind="stable")
    starts = np.zeros(n_groups + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    labels_sorted = labels[order]
    pos = np.arange(labels.shape[0], dtype=np.int64) - starts[labels_sorted]
    keep = pos < cap
    pad_idx = np.zeros((n_groups, cap), np.int64)
    pad_w = np.zeros((n_groups, cap), np.float32)
    pad_idx[labels_sorted[keep], pos[keep]] = order[keep]
    pad_w[labels_sorted[keep], pos[keep]] = 1.0
    return (x[torch.from_numpy(pad_idx).to(x.device)],
            torch.from_numpy(pad_w).to(x.device))


def _assign_children(model_type: str, level_params: dict, x: torch.Tensor,
                     parents: torch.Tensor, chunk: int = 32768) -> torch.Tensor:
    """Log-probs (n, arity) of each point under its own parent node model.
    Gathers the parent's parameters per point, in chunks of points to
    bound memory (the JAX build vmaps over all points at once)."""
    outs = []
    for s in range(0, x.shape[0], chunk):
        p = parents[s:s + chunk].long()
        own = {k: v[p] for k, v in level_params.items()}  # (n, ...) gathered
        xi = x[s:s + chunk, None, :]  # (n, 1, d)
        outs.append(_node_log_proba(model_type, own, xi)[:, 0, :])
    return torch.cat(outs, dim=0)


def build(seed, embeddings: torch.Tensor, arities: Sequence[int] = (256, 64),
          model_type: str = "kmeans", max_iter: int = 25, group_cap: Optional[int] = None,
          *, device=None) -> LMI:
    """Build an LMI of depth ``len(arities)`` over ``embeddings`` (M, d).

    ``seed``: an int or a `torch.Generator` on ``device``. Host
    orchestration as in the JAX build: the root is one `kmeans.fit`,
    level ``i >= 1`` one `kmeans.fit_many` over ``prod(arities[:i])``
    padded groups; every Lloyd assignment runs the kmeans_assign kernel
    on CUDA. Only ``model_type="kmeans"`` builds here.
    """
    _require_kmeans(model_type)
    if len(arities) < 1:
        raise ValueError("arities must name at least one level")
    dev = resolve_device(device)
    arities = tuple(int(a) for a in arities)
    x = torch.as_tensor(embeddings).to(device=dev, dtype=torch.float32)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    levels = [{"centroids": kmeans.fit(gen, x, arities[0], max_iter=max_iter).centroids}]
    # prefix[j] = mixed-radix node id of point j at the deepest fit level
    prefix = torch.argmax(_node_log_proba(model_type, levels[0], x), dim=-1).cpu().numpy()

    for i in range(1, len(arities)):
        n_nodes = math.prod(arities[:i])
        xs, ws = _pad_groups(x, prefix, n_nodes, group_cap, arities[i])
        st = kmeans.fit_many(gen, xs, ws, arities[i], max_iter=max_iter)
        del xs, ws
        levels.append({"centroids": st.centroids})
        child_logp = _assign_children(model_type, levels[i], x,
                                      torch.from_numpy(prefix).to(dev))
        child = torch.argmax(child_logp, dim=-1).cpu().numpy()
        prefix = prefix * arities[i] + child

    # ---- CSR bucket store
    n_leaves = math.prod(arities)
    perm = np.argsort(prefix, kind="stable")
    sizes = np.bincount(prefix, minlength=n_leaves)
    offsets = np.zeros(n_leaves + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    perm_t = torch.from_numpy(perm).to(dev)
    return LMI(
        arities=arities,
        model_type=model_type,
        levels=tuple(levels),
        bucket_offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
        sorted_ids=perm_t.to(torch.int32),
        sorted_embeddings=x[perm_t],
        max_bucket_size=int(sizes.max()),
    )


# -------------------------------------------------------------------- search


def leaf_log_probs(index, queries: torch.Tensor, temperatures=None) -> torch.Tensor:
    """(Q, n_leaves) joint leaf log-probabilities by exact enumeration:
    one batched node evaluation per level (params carry their node dim),
    accumulated along the mixed-radix leaf order."""
    temps = normalize_temperatures(temperatures, len(index.levels))
    q = queries.float()
    acc = _node_log_proba(index.model_type, index.levels[0], q, temps[0])  # (Q, a0)
    for i, params in enumerate(index.levels[1:], start=1):
        child = _node_log_proba(index.model_type, params, q, temps[i])  # (N, Q, a_i)
        joint = acc.T[:, :, None] + child
        acc = joint.permute(1, 0, 2).reshape(q.shape[0], -1)
    return acc


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: (values, indices) of the k
    largest, equal values in index order (a stable sort of ``-x``)."""
    sel = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, sel), sel


def beam_leaf_ranking(index, queries: torch.Tensor, beam_width, node_eval: str = "gather",
                      use_kernel: bool = False, interpret=None, temperatures=None,
                      planes=None):
    """Best-first (order (Q, R), logp (Q, R)) of the beam's surviving leaves.

    Before each expansion a level keeps only the top-``width`` prefixes
    per query and evaluates only their node models. ``beam_width`` is a
    scalar or a schedule of ``depth - 1`` widths (``widths[i-1]`` prunes
    before level ``i``); ``R = min(beam, N_last) * arities[-1]``.

    While the frontier still fits the beam nothing is pruned and the
    expansion stays the dense batched evaluation of `leaf_log_probs`, so
    a beam of at least ``prod(arities[:-1])`` gives the exact panel.

    ``node_eval`` picks how a pruned level reads its node models:
    ``"gather"`` gathers each pair's parameters and runs the family's
    `predict_log_proba` (plain torch, as JAX leaves it to XLA);
    ``"segmented"`` runs `beam_eval.ops.node_scores`, the hand-written
    kernel on CUDA tensors. ``planes``: prebuilt `core.planes.IndexPlanes`
    for the segmented mode, validated by the entry points (this body
    trusts the caller). ``use_kernel`` / ``interpret`` are kept for the
    JAX signature and change nothing.
    """
    del use_kernel, interpret
    if node_eval not in NODE_EVAL_MODES:
        raise ValueError(f"node_eval must be one of {NODE_EVAL_MODES}, got {node_eval!r}")
    widths = normalize_beam_widths(beam_width, index.depth)
    if widths is None:
        raise ValueError("beam_leaf_ranking needs a beam width; use "
                         "leaf_log_probs for exact enumeration")
    temps = normalize_temperatures(temperatures, index.depth)
    q = queries.float()
    nq = q.shape[0]
    acc = _node_log_proba(index.model_type, index.levels[0], q, temps[0])  # (Q, a0)
    prefix = None  # None == full enumeration so far (acc column j is prefix j)
    for i, params in enumerate(index.levels[1:], start=1):
        arity, width, temp = index.arities[i], widths[i - 1], temps[i]
        if prefix is None and acc.shape[-1] <= width:
            # dense expansion, identical to the leaf_log_probs level step
            child = _node_log_proba(index.model_type, params, q, temp)  # (N, Q, a)
            acc = (acc.T[:, :, None] + child).permute(1, 0, 2).reshape(nq, -1)
            continue
        if prefix is None:
            prefix = torch.arange(acc.shape[-1], device=q.device).expand(nq, -1)
        if acc.shape[-1] > width:
            acc, sel = _top(acc, width)
            prefix = torch.gather(prefix, 1, sel)
        if node_eval == "segmented":
            level_planes = (planes.levels[i - 1] if planes is not None
                            else be_ops.family_planes(index.model_type, params, temperature=temp))
            child = be_ops.node_scores(q, prefix, level_planes, index.model_type,
                                       temperature=temp)  # (Q, F, arity)
        else:
            own = {k: v[prefix] for k, v in params.items()}  # (Q, F, ...) gathered
            child = _node_log_proba(index.model_type, own, q[:, None, None, :], temp)[..., 0, :]
        acc = (acc[:, :, None] + child).reshape(nq, -1)
        prefix = (prefix[:, :, None] * arity
                  + torch.arange(arity, device=q.device)[None, None, :]).reshape(nq, -1)
    if prefix is None:
        prefix = torch.arange(acc.shape[-1], device=q.device).expand(nq, -1)
    acc, sel = _top(acc, acc.shape[-1])  # best-first order of the frontier
    return torch.gather(prefix, 1, sel), acc


class SearchResult:
    """Fixed-shape candidate sets for a batch of queries."""

    __slots__ = ("candidate_ids", "valid", "n_buckets", "n_candidates", "runs")

    def __init__(self, candidate_ids, valid, n_buckets, n_candidates, runs=None):
        self.candidate_ids = candidate_ids  # (Q, C) int32
        self.valid = valid  # (Q, C) bool
        self.n_buckets = n_buckets  # (Q,) int32
        self.n_candidates = n_candidates  # (Q,) int32
        self.runs = runs  # BucketRuns


class BucketRuns(NamedTuple):
    """Per-query bucket runs: run r of query q covers CSR rows
    ``starts[q, r] : starts[q, r] + lengths[q, r]`` (length 0 once the
    stop condition cut the ranked stream), in probability order. The
    candidate list is their concatenation."""

    starts: torch.Tensor  # (Q, R) int32
    lengths: torch.Tensor  # (Q, R) int32


def query_plan_params(index: LMI, stop_condition: float,
                      candidate_cap: Optional[int] = None) -> tuple[int, int]:
    """(stop_count, candidate_cap) for a query — host ints, no device
    sync when the index carries ``max_bucket_size`` (every build does).

    The capacity bound stop_count + max_bucket_size is exact: the ranked
    bucket stream is cut when the candidates *before* a bucket reach
    stop_count, so at most one bucket overshoots.
    """
    stop_count = max(1, math.ceil(stop_condition * index.n_objects))
    if candidate_cap is None:
        max_bucket = index.max_bucket_size or int(torch.max(index.bucket_sizes()))
        candidate_cap = stop_count + max_bucket
    return stop_count, int(candidate_cap)


def _visited_cut(order: torch.Tensor, sizes: torch.Tensor, stop_count: int):
    """Cut a best-first leaf ranking at the stop condition: bucket r is
    visited iff the candidates before it are < stop_count."""
    sz = sizes.long()[order]  # (Q, R)
    csum = torch.cumsum(sz, dim=-1)
    visited = (csum - sz) < stop_count
    return sz, visited


def rank_visited_buckets(logp: torch.Tensor, sizes: torch.Tensor, stop_count: int,
                         bucket_topk: Optional[int] = None):
    """Rank the leaves of a dense (Q, L) log-prob panel best-first and cut
    at the stop condition -> (order (Q, R), visited (Q, R), sz (Q, R)).

    JAX ranks with ``argsort(-logp)`` (stable) or ``top_k(logp, K)``;
    both keep equal log-probs in leaf order, which the stable sort of
    ``-logp`` reproduces. ``bucket_topk`` keeps the first K.
    """
    order = torch.sort(-logp, dim=-1, stable=True).indices
    if bucket_topk is not None and bucket_topk < logp.shape[-1]:
        order = order[:, :bucket_topk]
    sz, visited = _visited_cut(order, sizes, stop_count)
    return order, visited, sz


def beam_rank_visited_buckets(index, queries: torch.Tensor, sizes: torch.Tensor,
                              stop_count: int, beam_width, bucket_topk: Optional[int] = None,
                              node_eval: str = "gather", temperatures=None, planes=None):
    """`rank_visited_buckets` for the beam: rank only the beam's surviving
    leaves (`beam_leaf_ranking`, already best-first), keep the first
    ``bucket_topk`` and cut at the stop condition."""
    order, _logp = beam_leaf_ranking(index, queries, beam_width, node_eval=node_eval,
                                     temperatures=temperatures, planes=planes)
    if bucket_topk is not None and bucket_topk < order.shape[-1]:
        order = order[:, :bucket_topk]
    sz, visited = _visited_cut(order, sizes, stop_count)
    return order, visited, sz


def extract_rows(order: torch.Tensor, visited: torch.Tensor, offsets: torch.Tensor,
                 cap: int):
    """Map candidate slots to CSR rows: (rows (Q, cap) int32, valid
    (Q, cap), n_cands (Q,) int32).

    Slot j of query q lies in the visited bucket whose cumulative size
    first exceeds j: ``jnp.searchsorted(csum_q, slots, side="right")``
    per query in JAX, one batched ``torch.searchsorted(..., right=True)``
    here.
    """
    offsets = offsets.long()
    sizes = offsets[1:] - offsets[:-1]
    sz = torch.where(visited, sizes[order], 0)
    csum = torch.cumsum(sz, dim=-1)  # (Q, R) int64
    n_cands = csum[:, -1]
    n_q, n_r = csum.shape
    slots = torch.arange(cap, device=order.device)
    rank = torch.searchsorted(csum, slots.expand(n_q, cap).contiguous(), right=True)
    rank_c = torch.clamp(rank, max=n_r - 1)
    leaf_id = torch.gather(order, 1, rank_c)
    prev = torch.gather(csum, 1, torch.clamp(rank_c - 1, min=0))
    within = torch.where(rank > 0, slots - prev, slots)
    rows = offsets[leaf_id] + within
    valid = slots[None, :] < n_cands[:, None]
    rows = torch.where(valid, rows, 0).to(torch.int32)
    return rows, valid, n_cands.to(torch.int32)


def _search_core(index: LMI, queries: torch.Tensor, stop_count: int, cap: int,
                 bucket_topk: Optional[int] = None, beam_width=None, node_eval: str = "gather",
                 temperatures=None, planes=None):
    """Search body shared by every query entry point:
    -> (cand_ids, rows, valid, n_buckets, n_cands, runs).

    ``beam_width=None`` enumerates every leaf; a width or schedule prunes
    the level frontier (`beam_leaf_ranking`, with ``node_eval`` and the
    validated prebuilt ``planes``)."""
    if beam_width is None:
        logp = leaf_log_probs(index, queries, temperatures)  # (Q, L)
        order, visited, sz = rank_visited_buckets(logp, index.bucket_sizes(), stop_count,
                                                  bucket_topk)
    else:
        order, visited, sz = beam_rank_visited_buckets(
            index, queries, index.bucket_sizes(), stop_count, beam_width, bucket_topk,
            node_eval=node_eval, temperatures=temperatures, planes=planes)
    n_buckets = torch.sum(visited, dim=-1).to(torch.int32)
    rows, valid, n_cands = extract_rows(order, visited, index.bucket_offsets, cap)
    runs = BucketRuns(
        starts=index.bucket_offsets[order].to(torch.int32),
        lengths=torch.where(visited, sz, 0).to(torch.int32),
    )
    cand_ids = index.sorted_ids[rows.long()]
    return cand_ids, rows, valid, n_buckets, n_cands, runs


def _static_search_args(index, beam_width, temperatures, node_eval: str = "gather"):
    """(schedule, temps) in canonical form: `search(beam_width=B)` and
    `search(beam_width=(B,) * k)` run the same plan. Raises on an unknown
    ``node_eval``, whatever the beam."""
    if node_eval not in NODE_EVAL_MODES:
        raise ValueError(f"node_eval must be one of {NODE_EVAL_MODES}, got {node_eval!r}")
    return (normalize_beam_widths(beam_width, index.depth),
            normalize_temperatures(temperatures, index.depth))


def search(index: LMI, queries: torch.Tensor, stop_condition: float = 0.01,
           candidate_cap: Optional[int] = None, bucket_topk: Optional[int] = None,
           beam_width=None, node_eval: str = "gather", use_kernel: bool = False,
           interpret=None, temperatures=None, planes=None) -> SearchResult:
    """Batched LMI search: buckets are consumed in joint-probability order
    until the candidate count reaches ``stop_condition * M`` (the paper's
    dataset fraction; the last bucket may overshoot, hence the cap).
    ``beam_width`` prunes the level traversal (`beam_leaf_ranking`, with
    ``node_eval``); ``temperatures`` calibrate each level; ``planes`` are
    prebuilt node planes for the segmented beam, validated against the
    index revision and the temperatures. ``use_kernel`` / ``interpret``
    are kept for the JAX signature: on CUDA the kernels always run."""
    from repro_torch.core import planes as planes_lib

    del use_kernel, interpret
    stop_count, cap = query_plan_params(index, stop_condition, candidate_cap)
    widths, temps = _static_search_args(index, beam_width, temperatures, node_eval)
    planes = planes_lib.validate(index, planes, temps)
    cand_ids, _rows, valid, n_buckets, n_cands, runs = _search_core(
        index, queries.float(), stop_count, cap, bucket_topk, widths, node_eval, temps, planes)
    return SearchResult(cand_ids, valid, n_buckets, n_cands, runs)


def search_rows(index: LMI, queries: torch.Tensor, stop_condition: float = 0.01,
                candidate_cap: Optional[int] = None, bucket_topk: Optional[int] = None,
                beam_width=None, node_eval: str = "gather", use_kernel: bool = False,
                interpret=None, temperatures=None, planes=None):
    """Like `search` but -> (cand_ids, rows, valid) with CSR row indices."""
    from repro_torch.core import planes as planes_lib

    del use_kernel, interpret
    stop_count, cap = query_plan_params(index, stop_condition, candidate_cap)
    widths, temps = _static_search_args(index, beam_width, temperatures, node_eval)
    planes = planes_lib.validate(index, planes, temps)
    cand_ids, rows, valid, _nb, _nc, _runs = _search_core(
        index, queries.float(), stop_count, cap, bucket_topk, widths, node_eval, temps, planes)
    return cand_ids, rows, valid
