"""Host side of the fused candidate filter (counterpart of
``repro.kernels.lmi_filter.ops``): descriptor operands from the search's
`BucketRuns`, operand checks, and dispatch by device.

CUDA tensors launch the hand-written kernels of ``csrc/lmi_filter.cu``
(per-run descriptor gather + distance, then top-k or the full (Q, C)
matrix) or raise; CPU tensors take the plain version in `ref.py`. There
is no fallback from one to the other. The CUDA path needs the `runs`:
the row / segment gather variants of the TPU kernel (rows without runs)
are not ported yet (ROADMAP queue A, the next slice).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.lmi_filter import ref as lf_ref

METRICS = {"euclidean": 0, "sq_euclidean": 1, "cosine": 2}

# launches of the CUDA kernels by these wrappers, for run-time proof that a
# path went through them (chip_smoke.py resets and reads it)
LAUNCHES = {"lmi_filter_topk_desc": 0, "lmi_filter_range_desc": 0}

_STORE_DTYPES = (torch.float32, torch.bfloat16)


def _run_descriptors(runs, cap: int):
    """Compact `lmi.BucketRuns` into the kernel's descriptor operands.

    -> (nrun (Q,) i32, dstart/doff/dlen (Q, K) i32) with K = min(R, cap):
    run r of query q covers candidate slots ``doff : doff + dlen`` with
    CSR rows ``dstart : dstart + dlen``. Slot offsets are the running sum
    of the run lengths; lengths are clipped to the candidate capacity
    (the last visited bucket may overshoot it). Nonzero runs are
    compacted to the front, keeping their order, so ``doff`` is
    ascending (the kernels' run cursor relies on that); the zero-length
    runs follow, also in order. That is the JAX package's stable
    ``argsort(1 - nz)``, computed as a stable partition (two running
    counts and one scatter) instead of a sort over all R ranked leaves.
    """
    starts = runs.starts.long()
    lengths = runs.lengths.long()
    off = torch.cumsum(lengths, dim=1) - lengths
    eff = torch.minimum(torch.clamp(cap - off, min=0), lengths)  # clip the overshoot
    nz = eff > 0
    nrun = torch.sum(nz, dim=1)
    dest = torch.where(nz, torch.cumsum(nz, dim=1) - 1,
                       nrun[:, None] + torch.cumsum(~nz, dim=1) - 1)
    k = min(starts.shape[1], cap)
    out = torch.empty((3, *starts.shape), dtype=torch.int32, device=starts.device)
    out.scatter_(2, dest[None].expand(3, -1, -1),
                 torch.stack([starts, off, eff]).to(torch.int32))
    dstart, doff, dlen = out[:, :, :k]
    return nrun.to(torch.int32), dstart, doff, dlen


def _pad_descriptors(runs, cap: int, bq: int = 1):
    """Descriptor operands padded on the query axis to a multiple of
    ``bq`` (padded queries get no runs). The CUDA kernels run one block
    per query and need no padding (``bq=1``); the TPU wrapper pads to its
    8-query blocks, which ``bq=8`` reproduces for comparison."""
    ops = _run_descriptors(runs, cap)
    pad = -ops[0].shape[0] % bq
    if pad == 0:
        return ops
    return tuple(torch.nn.functional.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in ops)


def _lib():
    lib = kernels.load("lmi_filter")
    if lib.lmi_filter_topk_desc.restype is not ctypes.c_int:
        p, i = ctypes.c_void_p, ctypes.c_int
        common = [p, p, i, p, p, p, p, p, i, i, i, i, i]
        lib.lmi_filter_range_desc.restype = i
        lib.lmi_filter_range_desc.argtypes = common + [p, p]
        lib.lmi_filter_topk_desc.restype = i
        lib.lmi_filter_topk_desc.argtypes = common + [i, p, p, p]
    return lib


def _check_desc_operands(q, store, valid, nrun, dstart, doff, dlen, metric: str):
    """Raise on what the kernels do not take; -> the ctypes arguments they
    share (the tensors must stay alive until the launch)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if store.dtype not in _STORE_DTYPES:
        raise NotImplementedError(
            f"the CUDA filter takes float32 or bfloat16 stores, got {store.dtype}; "
            "the quantized tiers are the next slice (ROADMAP queue A)")
    tensors = (("queries", q, torch.float32), ("valid", valid, torch.bool),
               ("nrun", nrun, torch.int32), ("dstart", dstart, torch.int32),
               ("doff", doff, torch.int32), ("dlen", dlen, torch.int32))
    for name, t, dtype in tensors + (("store", store, store.dtype),):
        if t.device != store.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every operand must be on {store.device} (CUDA)")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_q, d = q.shape
    c = valid.shape[1]
    n_desc = dstart.shape[1]
    if store.dim() != 2 or store.shape[1] != d:
        raise ValueError(f"store {tuple(store.shape)} does not match queries {tuple(q.shape)}")
    if (valid.shape[0] != n_q or tuple(nrun.shape) != (n_q,)
            or any(tuple(t.shape) != (n_q, n_desc) for t in (dstart, doff, dlen))):
        raise ValueError("queries, valid and the descriptors disagree on their shapes")
    raw = store.view(torch.int16) if store.dtype == torch.bfloat16 else store
    args = [kernels.ptr(q), kernels.ptr(raw), int(store.dtype == torch.bfloat16)]
    args += [kernels.ptr(t) for t in (valid, nrun, dstart, doff, dlen)]
    return args + [n_q, c, n_desc, d, METRICS[metric]]


def lmi_filter_range_desc(q, store, valid, nrun, dstart, doff, dlen,
                          metric: str = "euclidean"):
    """Launch the range kernel on descriptor operands -> (Q, C) f32."""
    args = _check_desc_operands(q, store, valid, nrun, dstart, doff, dlen, metric)
    out = torch.empty(valid.shape, dtype=torch.float32, device=store.device)
    with torch.cuda.device(store.device):
        status = _lib().lmi_filter_range_desc(*args, kernels.ptr(out), kernels.stream_handle())
    kernels.check_status("lmi_filter_range_desc", status)
    LAUNCHES["lmi_filter_range_desc"] += 1
    return out


def lmi_filter_topk_desc(q, store, valid, nrun, dstart, doff, dlen, k: int,
                         metric: str = "euclidean"):
    """Launch the top-k kernel on descriptor operands -> (dist, slot) (Q, k)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    args = _check_desc_operands(q, store, valid, nrun, dstart, doff, dlen, metric)
    dist = torch.empty((q.shape[0], k), dtype=torch.float32, device=store.device)
    slot = torch.empty((q.shape[0], k), dtype=torch.int32, device=store.device)
    with torch.cuda.device(store.device):
        status = _lib().lmi_filter_topk_desc(*args, k, kernels.ptr(dist), kernels.ptr(slot),
                                             kernels.stream_handle())
    kernels.check_status("lmi_filter_topk_desc", status)
    LAUNCHES["lmi_filter_topk_desc"] += 1
    return dist, slot


def desc_operands(queries, valid, runs):
    """The descriptor-kernel operands of a query batch: (q, valid, nrun,
    dstart, doff, dlen), contiguous, from the search's `BucketRuns`."""
    if runs is None:
        raise NotImplementedError(
            "the CUDA filter gathers by per-run descriptors and needs the search's "
            "BucketRuns; the row / segment gather kernels (TPU kernels #3/#4) are "
            "not ported yet (ROADMAP queue A)")
    nrun, dstart, doff, dlen = _run_descriptors(runs, valid.shape[1])
    return (queries.float().contiguous(), valid.contiguous(), nrun.contiguous(),
            dstart.contiguous(), doff.contiguous(), dlen.contiguous())


def lmi_filter_range(queries, rows, valid, embeddings, metric: str = "euclidean",
                     runs=None):
    """Fused gather + distance over the candidate lists -> (Q, C) f32;
    invalid or uncovered slots get +3.4e38. On CUDA the candidate rows
    come from ``runs`` (the per-run descriptor gather); ``rows`` is only
    read by the plain version."""
    if embeddings.device.type == "cpu":
        return lf_ref.lmi_filter_ref(queries, rows, valid, embeddings, metric=metric)
    q, v, nrun, dstart, doff, dlen = desc_operands(queries, valid, runs)
    return lmi_filter_range_desc(q, embeddings.contiguous(), v, nrun, dstart, doff, dlen,
                                 metric=metric)


def lmi_filter_topk(queries, rows, valid, embeddings, k: int, metric: str = "euclidean",
                    runs=None):
    """Fused gather + distance + top-k -> (dist, slot) (Q, k), ascending
    with ties to the lowest slot; exhausted slots hold +3.4e38 / -1 on
    CUDA (the plain version leaves an arbitrary invalid slot there —
    callers mask on distance, as with the TPU kernel and its oracle)."""
    if embeddings.device.type == "cpu":
        return lf_ref.lmi_filter_topk_ref(queries, rows, valid, embeddings, k, metric=metric)
    q, v, nrun, dstart, doff, dlen = desc_operands(queries, valid, runs)
    return lmi_filter_topk_desc(q, embeddings.contiguous(), v, nrun, dstart, doff, dlen, k,
                                metric=metric)
