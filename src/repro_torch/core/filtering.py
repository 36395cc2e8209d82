"""Stage (iii) of the paper's pipeline: filtering the LMI candidate set
(counterpart of ``repro.core.filtering``).

The LMI returns a fixed-shape (Q, C) candidate set; filtering computes a
cheap vector distance from each query to its candidate rows of the
`CandidateStore` and applies the query predicate — a radius cut
(`range_query`, paper Table 2) or the k nearest (`knn_query`, Table 3).

`filter_range` / `filter_topk` are the filtering entry points, for every
store tier (f32 / bf16 / int8 / fp8, row or bucket scales) and both
contraction domains (``compute_dtype``). Dispatch is by device, not by
``use_kernel``: on CUDA tensors they always launch the hand-written
lmi_filter kernel (per-run descriptor gather with the search's
`BucketRuns`, the row gather without them; no fallback), on CPU tensors
they run the plain version in `repro_torch.kernels.lmi_filter.ref`.
``use_kernel`` is accepted for the JAX signatures, where its default
False means "the oracle"; here it changes nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import lmi as lmi_lib
from repro_torch.core import store as store_lib
from repro_torch.core.distances import get_pairwise
from repro_torch.kernels.lmi_filter import ops as lf_ops

_BIG = 3.4e38


class FilterResult(NamedTuple):
    ids: torch.Tensor  # (Q, C) candidate ids (failing the predicate -> -1)
    distances: torch.Tensor  # (Q, C) distance to the query (invalid -> +BIG)
    mask: torch.Tensor  # (Q, C) bool — passes the predicate


def _effective_compute(store, compute_dtype: str) -> str:
    """The compute dtype the filter runs, by the JAX package's rule: the
    integer domain needs int8 rows plus the store's integer norms; every
    other store (f32 / bf16 / fp8, or an int8 store without norms) runs
    float32. A rule of the reference's dtypes, not a device fallback."""
    if compute_dtype == "int8" and store.dtype == "int8" and store.norms is not None:
        return "int8"
    return "float32"


def _quant_kwargs(store, runs, compute: str) -> dict:
    """The filter wrapper's quantization operands from the store: bucket
    scales ride as raw bucket scalars when the descriptor gather
    (``runs``) takes them per run, and are expanded to per-row scales
    otherwise; the integer domain adds the norms."""
    kw = {"compute_dtype": compute}
    if store.scales is not None:
        if store.scale_granularity == "bucket" and runs is not None:
            kw["bucket_scales"] = store.scales
            kw["offsets"] = store.offsets
        else:
            kw["scales"] = store_lib.row_scales(store)
    if compute == "int8":
        kw["norms"] = store.norms
    return kw


def filter_range(store, queries, rows, valid, *, metric: str = "euclidean",
                 use_kernel: bool = False, runs=None, compute_dtype: str = "float32"):
    """(Q, C) f32 distances of each query to its candidate rows of
    ``store``; invalid slots get +3.4e38. ``runs`` (`lmi.BucketRuns`)
    selects the CUDA kernel's descriptor gather; ``compute_dtype="int8"``
    the integer domain (int8 stores with norms; see `_effective_compute`)."""
    del use_kernel
    compute = _effective_compute(store, compute_dtype)
    return lf_ops.lmi_filter_range(queries, rows, valid, store.data, metric=metric, runs=runs,
                                   **_quant_kwargs(store, runs, compute))


def filter_topk(store, queries, rows, valid, k: int, *, metric: str = "euclidean",
                use_kernel: bool = False, runs=None, compute_dtype: str = "float32"):
    """Top-k smallest candidate distances over ``store``: -> (dist (Q, k)
    ascending, slot (Q, k) into the candidate axis), ties to the lowest
    slot. ``runs`` and ``compute_dtype`` as in `filter_range`."""
    del use_kernel
    compute = _effective_compute(store, compute_dtype)
    return lf_ops.lmi_filter_topk(queries, rows, valid, store.data, k, metric=metric,
                                  runs=runs, **_quant_kwargs(store, runs, compute))


def _query_impl(index, store, queries, radius, *, stop_count: int, cap: int, metric: str,
                mode: str, k: int, bucket_topk: Optional[int] = None, beam_width=None,
                node_eval: str = "gather", temperatures=None, planes=None,
                compute_dtype: str = "float32"):
    """The whole query: search -> filter -> predicate. ``store`` shares
    the index's CSR layout, so the search's rows address it directly.
    ``radius`` is a Python float; comparing it with float32 distances
    rounds it to float32, as JAX's ``jnp.float32(radius)`` does.
    ``beam_width`` / ``temperatures`` arrive normalized and ``planes``
    validated from the entry points below."""
    cand_ids, rows, valid, _nb, _nc, runs = lmi_lib._search_core(
        index, queries, stop_count, cap, bucket_topk, beam_width, node_eval, temperatures,
        planes)
    if mode == "range":
        d = filter_range(store, queries, rows, valid, metric=metric, runs=runs,
                         compute_dtype=compute_dtype)
        mask = d <= radius
        return torch.where(mask, cand_ids, -1), d, mask
    # kNN: top-k then range-limit (equivalent to limit-then-top-k). k may
    # exceed the candidate capacity (tiny buckets): clamp the filter and
    # pad the tail with not-found slots, as the JAX plan does.
    kk = min(k, cap)
    top_d, top_slot = filter_topk(store, queries, rows, valid, kk, metric=metric, runs=runs,
                                  compute_dtype=compute_dtype)
    if kk < k:
        top_d = torch.nn.functional.pad(top_d, (0, k - kk), value=_BIG)
        top_slot = torch.nn.functional.pad(top_slot, (0, k - kk), value=-1)
    top_ids = torch.gather(cand_ids, 1, torch.clamp(top_slot, min=0).long())
    found = (top_d < _BIG) & (top_d <= radius)
    return (torch.where(found, top_ids, -1),
            torch.where(found, top_d, torch.full_like(top_d, float("inf"))), found)


def _store_for(index, store):
    """Default store: the f32 view of the index's CSR arrays. A given
    store must match the index's ``index_revision``."""
    if store is None:
        return store_lib.from_lmi(index)
    if store.revision != index.index_revision:
        raise ValueError(
            f"stale CandidateStore: store revision {store.revision} != index "
            f"revision {index.index_revision} — refresh it with store.refresh(index, store)")
    return store


def _planes_for(index, planes, temps):
    """Staleness gate for prebuilt node planes, next to `_store_for`:
    `core.planes.validate` rejects planes of another index revision,
    temperature schedule or depth (ValueError)."""
    from repro_torch.core import planes as planes_lib

    return planes_lib.validate(index, planes, temps)


def _plan_args(index, stop_condition, candidate_cap, beam_width, temperatures, node_eval,
               planes) -> dict:
    """The keyword arguments of `_query_impl` an entry point resolves:
    query plan sizes, the normalized beam and temperatures, the node
    evaluation mode and the validated planes."""
    stop_count, cap = lmi_lib.query_plan_params(index, stop_condition, candidate_cap)
    widths, temps = lmi_lib._static_search_args(index, beam_width, temperatures, node_eval)
    return dict(stop_count=stop_count, cap=cap, beam_width=widths, node_eval=node_eval,
                temperatures=temps, planes=_planes_for(index, planes, temps))


def range_query(index, queries, radius: float, stop_condition: float = 0.01,
                metric: str = "euclidean", radius_scale: float = 1.0,
                use_kernel: bool = False, candidate_cap: Optional[int] = None,
                store=None, bucket_topk: Optional[int] = None, beam_width=None,
                node_eval: str = "gather", temperatures=None, planes=None,
                compute_dtype: str = "float32") -> FilterResult:
    """End-to-end LMI range query. ``radius`` is in ground-truth units;
    ``radius_scale`` maps it into embedding space (paper footnote 3).
    ``beam_width`` (scalar or per-level schedule; None == exact),
    ``node_eval`` ("gather" / "segmented"), ``temperatures`` and prebuilt
    ``planes`` shape the leaf ranking as in `lmi.search`; ``store`` picks
    the candidate-store precision and ``compute_dtype`` ("float32" /
    "int8") the filter's contraction domain."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    ids, d, mask = _query_impl(
        index, _store_for(index, store), q, radius * radius_scale, metric=metric,
        mode="range", k=0, bucket_topk=bucket_topk, compute_dtype=compute_dtype,
        **_plan_args(index, stop_condition, candidate_cap, beam_width, temperatures,
                     node_eval, planes))
    return FilterResult(ids=ids, distances=d, mask=mask)


def knn_query(index, queries, k: int, stop_condition: float = 0.01,
              metric: str = "euclidean", max_radius: Optional[float] = None,
              radius_scale: float = 1.0, use_kernel: bool = False,
              candidate_cap: Optional[int] = None, store=None,
              bucket_topk: Optional[int] = None, beam_width=None, node_eval: str = "gather",
              temperatures=None, planes=None, compute_dtype: str = "float32"):
    """kNN over the candidate set (paper Table 3: 30NN with max radius).
    -> (ids (Q, k), distances (Q, k)); slots beyond the candidates found
    hold id -1 / distance +inf. The beam, store and compute arguments are
    `range_query`'s."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    radius = _BIG if max_radius is None else max_radius * radius_scale
    ids, d, _found = _query_impl(
        index, _store_for(index, store), q, radius, metric=metric, mode="knn", k=int(k),
        bucket_topk=bucket_topk, compute_dtype=compute_dtype,
        **_plan_args(index, stop_condition, candidate_cap, beam_width, temperatures,
                     node_eval, planes))
    return ids, d


# ------------------------------------------------------------ brute force


def brute_force_distances(queries, db, metric: str = "euclidean"):
    """Exact (Q, M) distance panel — the linear-scan baseline."""
    return get_pairwise(metric)(queries.float(), db.float())


def brute_force_knn(queries, db, k: int, metric: str = "euclidean"):
    """-> (ids (Q, k) int32, distances (Q, k)), ties to the lowest id."""
    d = brute_force_distances(queries, db, metric=metric)
    dist, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :k].to(torch.int32), dist[:, :k]


def brute_force_range(queries, db, radius: float, metric: str = "euclidean"):
    return brute_force_distances(queries, db, metric=metric) <= radius


def knn_agree(ids_a, d_a, ids_b, d_b, atol: float) -> np.ndarray:
    """(Q,) bool: two kNN answers agree modulo distance ties.

    Rows agree when their ascending distances match within ``atol`` and
    every id in one answer but not the other lies within ``atol`` of the
    k-th distance — a near-tie at the cut that float association may
    order either way. Not-found slots (id -1) must coincide."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    d_a, d_b = np.asarray(d_a, np.float64), np.asarray(d_b, np.float64)
    ok = np.ones(ids_a.shape[0], bool)
    for i in range(ids_a.shape[0]):
        fa, fb = ids_a[i] >= 0, ids_b[i] >= 0
        if not np.array_equal(fa, fb) or not np.allclose(d_a[i][fa], d_b[i][fb], rtol=0, atol=atol):
            ok[i] = False
            continue
        if not fa.any():
            continue
        kth = max(d_a[i][fa][-1], d_b[i][fb][-1])
        for ids, d, other in ((ids_a[i], d_a[i], ids_b[i]), (ids_b[i], d_b[i], ids_a[i])):
            extra = ~np.isin(ids, other) & (ids >= 0)
            if np.any(d[extra] < kth - atol):
                ok[i] = False
    return ok
