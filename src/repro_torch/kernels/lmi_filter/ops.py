"""Host side of the fused candidate filter (counterpart of
``repro.kernels.lmi_filter.ops``): descriptor operands from the search's
`BucketRuns`, query quantization and scale delivery of the quantized
tiers, operand checks, and dispatch by device.

CUDA tensors launch the hand-written kernel of ``csrc/lmi_filter.cu`` or
raise; CPU tensors take the plain version in `ref.py`. There is no
fallback from one to the other. Two gather forms, as in the JAX package:
with the search's ``runs`` the kernel expands per-run descriptors
(`lmi_filter_{topk,range}_desc`), without them it reads each slot's row
from the (Q, C) ``rows`` matrix (`lmi_filter_{topk,range}_rows`; JAX's
segment metadata is a TPU copy schedule and has no counterpart here).

Quantized stores (int8 / float8_e4m3fn) carry per-row ``scales`` (read
by the kernel at each slot's row) or, on the descriptor form, per-bucket
``bucket_scales`` + ``offsets`` delivered as one scalar per run
(`_run_scales`). ``compute_dtype="int8"`` (int8 stores with their
``norms``) runs the integer domain: queries are quantized here on the
device (`_quantize_queries`), the kernel takes an int8 x int8 -> int32
dot, and the scales enter only the epilogue.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.store import expand_bucket_scales, true_divide
from repro_torch.kernels.lmi_filter import ref as lf_ref

METRICS = {"euclidean": 0, "sq_euclidean": 1, "cosine": 2}

COMPUTE_DTYPES = ("float32", "int8")

# store dtype -> the kernel's store-type code
_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_STORE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8",
                torch.float8_e4m3fn: "float8_e4m3fn"}
_SCALE_CODES = {"none": 0, "row": 1, "run": 2}

# launches of the CUDA kernel by these wrappers, for run-time proof that a
# path went through it (chip_smoke.py resets and reads them): by kernel,
# and by tier "<kernel>:<store dtype>:<scale mode>:<compute dtype>", so a
# call that resolved to another tier cannot pass for the one expected
LAUNCHES = {"lmi_filter_topk_desc": 0, "lmi_filter_range_desc": 0,
            "lmi_filter_topk_rows": 0, "lmi_filter_range_rows": 0}
TIER_LAUNCHES: dict[str, int] = {}


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


def _quantize_queries(q):
    """Symmetric per-query int8 quantization: -> (qi (Q, d) int8, s_q
    (Q, 1) f32) with q ~= s_q * qi; all-zero rows get qi = 0. Device-side
    torch ops, no host sync."""
    am = torch.amax(torch.abs(q), dim=1, keepdim=True)
    s = true_divide(torch.clamp(am, min=1e-12), 127.0)
    qi = torch.clamp(torch.round(q / s), -127, 127).to(torch.int8)
    return qi, s


def _run_scales(dstart, bucket_scales, offsets):
    """(Q, K) per-run dequant scales of a bucket-granularity store: each
    descriptor is one bucket's run, so its scale is the scale of the
    bucket its CSR start row falls in. Zero-length descriptors pick up an
    arbitrary bucket's scale; they cover no slot, so it never matters."""
    off = offsets.to(torch.int32)
    sc = bucket_scales.float()
    bid = torch.searchsorted(off, dstart.to(torch.int32).contiguous(), right=True) - 1
    return sc[torch.clamp(bid, 0, sc.shape[0] - 1)]


def _quant_plan(store_dtype: str, compute_dtype: str, scales, bucket_scales,
                offsets, norms, runs):
    """Resolve (scale_mode, int compute) and validate the operand combo,
    with the JAX package's errors. Row mode needs per-row ``scales``; run
    mode (descriptor form only) needs ``bucket_scales`` + ``offsets``; the
    integer domain needs an int8 store and its prebuilt ``norms``."""
    quantized = store_dtype in ("int8", "float8_e4m3fn")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}; expected one of {COMPUTE_DTYPES}")
    if compute_dtype == "int8":
        if store_dtype != "int8":
            raise ValueError(
                "compute_dtype='int8' needs an int8 store (integer-domain "
                f"contraction over raw int8 rows); got a {store_dtype} store")
        if norms is None:
            raise ValueError(
                "compute_dtype='int8' needs the store's prebuilt integer row "
                "norms (CandidateStore.norms — rebuild the store with "
                "store.quantize)")
    if not quantized:
        return "none", False
    if runs is not None and bucket_scales is not None:
        return "run", compute_dtype == "int8"
    if scales is None:
        raise ValueError(
            f"a {store_dtype} store needs per-row scales (or bucket_scales + "
            "offsets on the descriptor path)")
    return "row", compute_dtype == "int8"


def _lib():
    lib = kernels.load("lmi_filter")
    if lib.lmi_filter.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lmi_filter.restype = i
        lib.lmi_filter.argtypes = [i, i, i, i, i] + [p] * 11 + [i] * 5 + [p, p, p]
    return lib


def _check(name: str, t, dtype, shape, dev) -> None:
    if t is None:
        raise ValueError(f"{name} is required here")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}; every operand must be on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(q, store, valid, *, k: int = 0, metric: str = "euclidean", rows=None, desc=None,
           scales=None, scale_mode: str = "none", norms=None, qscale=None):
    """Launch the filter kernel -> (Q, C) f32 distances (``k == 0``) or
    (dist (Q, k) f32, slot (Q, k) i32) ascending with ties to the lowest
    slot, exhausted entries +3.4e38 / -1.

    Gather form: ``desc = (nrun, dstart, doff, dlen)`` or ``rows`` (Q, C)
    int32, exactly one. ``q`` is (Q, d) f32, or int8 codes with ``qscale``
    (Q, 1) f32 and ``norms`` (M,) int32 for the integer domain (int8
    store). ``scales``: (M,) f32 per row (``scale_mode="row"``) or (Q, K)
    f32 per run (``"run"``, descriptor form). Raises on what the kernel
    does not take; rows outside the store are read as no candidate."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if store.dtype not in _STORE_CODES:
        raise TypeError(f"the CUDA filter takes {tuple(_STORE_NAMES.values())} stores, "
                        f"got {store.dtype}")
    if (rows is None) == (desc is None):
        raise ValueError("give exactly one gather form: rows or descriptors")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    dev = store.device
    if dev.type != "cuda":
        raise ValueError(f"the store is on {dev}; the CUDA filter needs CUDA tensors")
    n_q, d = q.shape
    m = store.shape[0]
    c = valid.shape[1]
    intdom = qscale is not None
    _check("store", store, store.dtype, (m, d), dev)
    _check("queries", q, torch.int8 if intdom else torch.float32, (n_q, d), dev)
    _check("valid", valid, torch.bool, (n_q, c), dev)
    if intdom:
        if store.dtype != torch.int8 or norms is None:
            raise ValueError("the integer domain takes an int8 store with its norms")
        _check("qscale", qscale, torch.float32, (n_q, 1), dev)
        _check("norms", norms, torch.int32, (m,), dev)
    n_desc = 0
    if desc is not None:
        n_desc = desc[1].shape[1]
        _check("nrun", desc[0], torch.int32, (n_q,), dev)
        for dname, t in zip(("dstart", "doff", "dlen"), desc[1:]):
            _check(dname, t, torch.int32, (n_q, n_desc), dev)
    else:
        _check("rows", rows, torch.int32, (n_q, c), dev)
    if scale_mode not in _SCALE_CODES:
        raise ValueError(f"unknown scale mode {scale_mode!r}")
    if (scale_mode == "none") != (store.dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"scale mode {scale_mode!r} does not fit a {store.dtype} store")
    if scale_mode == "run" and desc is None:
        raise ValueError("per-run scales need the descriptor gather")
    if scale_mode != "none":
        _check("scales", scales, torch.float32, (m,) if scale_mode == "row" else (n_q, n_desc),
               dev)
    raw = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}.get(store.dtype)
    raw = store if raw is None else store.view(raw)
    nrun, dstart, doff, dlen = desc if desc is not None else (None,) * 4

    def p(t):
        return None if t is None else kernels.ptr(t)

    if k:
        out_d = torch.empty((n_q, k), dtype=torch.float32, device=dev)
        out_s = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    else:
        out_d, out_s = torch.empty((n_q, c), dtype=torch.float32, device=dev), None
    with torch.cuda.device(dev):
        status = _lib().lmi_filter(
            _STORE_CODES[store.dtype], _SCALE_CODES[scale_mode], int(intdom), METRICS[metric], k,
            p(q), p(qscale), p(raw), p(scales), p(norms), p(valid), p(rows),
            p(nrun), p(dstart), p(doff), p(dlen), n_q, c, n_desc, d, m,
            p(out_d), p(out_s), kernels.stream_handle())
    name = f"lmi_filter_{'topk' if k else 'range'}_{'rows' if rows is not None else 'desc'}"
    kernels.check_status(name, status)
    LAUNCHES[name] += 1
    tier = (f"{name}:{_STORE_NAMES[store.dtype]}:{scale_mode}:"
            f"{'int8' if intdom else 'float32'}")
    TIER_LAUNCHES[tier] = TIER_LAUNCHES.get(tier, 0) + 1
    return (out_d, out_s) if k else out_d


def desc_operands(queries, valid, runs):
    """The descriptor-form operands of a query batch: (q, valid, (nrun,
    dstart, doff, dlen)), contiguous, from the search's `BucketRuns`."""
    nrun, dstart, doff, dlen = _run_descriptors(runs, valid.shape[1])
    return (queries.float().contiguous(), valid.contiguous(),
            tuple(t.contiguous() for t in (nrun, dstart, doff, dlen)))


def _filter(queries, rows, valid, embeddings, k: int, metric: str, scales, runs,
            compute_dtype: str, norms, bucket_scales, offsets):
    """Shared body of `lmi_filter_range` (k == 0) and `lmi_filter_topk`."""
    store_dtype = _STORE_NAMES.get(embeddings.dtype, str(embeddings.dtype))
    scale_mode, intdom = _quant_plan(store_dtype, compute_dtype, scales, bucket_scales,
                                     offsets, norms, runs)
    if scale_mode == "none":
        scales = None  # float stores ignore scales, as in the JAX wrapper
    if embeddings.device.type == "cpu":
        if scale_mode == "run":
            scales = expand_bucket_scales(bucket_scales, offsets, embeddings.shape[0])
        d = (lf_ref.lmi_filter_int_ref(queries, rows, valid, embeddings, scales, norms,
                                       metric=metric) if intdom
             else lf_ref.lmi_filter_ref(queries, rows, valid, embeddings, metric=metric,
                                        scales=scales))
        if not k:
            return d
        dist, slot = torch.sort(d, dim=1, stable=True)  # ties to the lowest slot
        return dist[:, :k], slot[:, :k].to(torch.int32)
    if runs is not None:
        q, v, desc = desc_operands(queries, valid, runs)
        gather = dict(desc=desc)
        if scale_mode == "run":
            scales = _run_scales(desc[1], bucket_scales, offsets)
    else:
        q, v = queries.float().contiguous(), valid.contiguous()
        gather = dict(rows=rows.to(torch.int32).contiguous())
    quant = dict(scale_mode=scale_mode,
                 scales=None if scales is None else scales.float().contiguous())
    if intdom:
        q, qscale = _quantize_queries(q)
        quant.update(norms=norms.contiguous(), qscale=qscale.contiguous())
    return launch(q, embeddings.contiguous(), v, k=k, metric=metric, **gather, **quant)


def lmi_filter_range(queries, rows, valid, embeddings, metric: str = "euclidean",
                     scales=None, runs=None, compute_dtype: str = "float32", norms=None,
                     bucket_scales=None, offsets=None):
    """Fused gather + dequant + distance over the candidate lists -> (Q, C)
    f32; invalid or uncovered slots get +3.4e38. ``runs``
    (`lmi.BucketRuns`) selects the descriptor gather on CUDA; without them
    the kernel reads ``rows``. ``scales`` (M,) per-row dequant scales;
    ``bucket_scales`` (L,) + ``offsets`` (L + 1,) per-bucket scales, one
    scalar per run on the descriptor form; ``compute_dtype="int8"`` with
    ``norms`` (M,) i32 the integer domain (module docstring)."""
    return _filter(queries, rows, valid, embeddings, 0, metric, scales, runs, compute_dtype,
                   norms, bucket_scales, offsets)


def lmi_filter_topk(queries, rows, valid, embeddings, k: int, metric: str = "euclidean",
                    scales=None, runs=None, compute_dtype: str = "float32", norms=None,
                    bucket_scales=None, offsets=None):
    """Fused gather + dequant + distance + top-k -> (dist, slot) (Q, k),
    ascending with ties to the lowest slot; exhausted slots hold
    +3.4e38 / -1 on CUDA (the plain version leaves an arbitrary invalid
    slot there — callers mask on distance, as with the TPU kernel and its
    oracle). Operands as in `lmi_filter_range`."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return _filter(queries, rows, valid, embeddings, k, metric, scales, runs, compute_dtype,
                   norms, bucket_scales, offsets)
