#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # everything, on one CUDA card
    python3 chip_smoke.py --quick    # 20k chains, no CLIs, the LM at 2 layers
    python3 chip_smoke.py --lm-only  # the build and phase 6 alone, no result line

Phases, each of which fails the run (non-zero exit) if anything is off:

 1. build: every CUDA kernel of the port, one ``nvcc`` per source, all
    started together;
 2. main path at the paper's published configuration
    (``repro.configs.lmi_protein.make_full()``: 518,576 chains, 10
    sections -> 45 dims, 2-level K-Means (256, 64), stop 0.01, 30NN,
    Euclidean, bfloat16 store, 512-query batches), through the port's
    own entry points: generate + embed in chunks, ``lmi.build``,
    ``filtering.knn_query`` and ``filtering.range_query``. The kernels'
    launch counts are set to 0 just before and read just after; each
    kernel must have launched. The kernel path's answers must equal the
    plain path's (the same index on the CPU) modulo distance ties;
    recall@30 vs brute force is printed. The index is then built a
    second time from the seed, which must equal the first bit for bit
    (every level's centroids, the offsets, the ids; a fingerprint line
    prints empty buckets, the centroids' SHA-256 and recall@30), with its
    stages timed per level (seeding, assignment, sums and repair, the
    loop, padding, children), the level caps and the build's peak memory;
 2b. quantized stores over the main path's index and query batches (no
    second generation): int8 with row scales and float32 compute, int8
    with bucket scales and int8 compute, fp8-e4m3 with row scales, fp8
    with bucket scales. Per store: the counts are set to 0 before and read
    after; the store's kernel tier must have launched in both gather forms
    (the query plan's descriptors, and ``filter_topk`` / ``filter_range``
    called without runs). kNN and range answers equal the plain path's on
    the same search modulo ties; the card's codes, scales and norms are
    compared with the CPU's; QPS over 4 timed batches, ``knn_query`` back
    to back and device only, recall@30 vs brute force and vs the float32
    store, and the filter kernel's ms, plain ms and byte bound are printed;
 3. depth-3 path, the configuration's beam serving shapes
    (``search_512q_d3_beam_seg``: beam 64, segmented node evaluation;
    ``search_512q_d3_calib``: widths (64, 16), temperatures (1.0, 0.8,
    0.7), segmented, prebuilt planes) on a (64, 64, 64) K-Means stack
    built over the main path's 518,576 embeddings (no second generation),
    bfloat16 store. Counts are set to 0 before the build and read after
    both serving points: beam_eval, the top-k filter and kmeans_assign
    must each have launched. Per point: QPS over 4 timed 512-query kNN
    batches, stage times, recall@30 vs exact enumeration and vs brute
    force, and the kernel path against the plain segmented and the gather
    paths (log-probs, leaf sets, ranking and kNN answers modulo ties);
 4. CLI: ``build_index`` -> ``serve`` at the CLI defaults (20k chains,
    (32, 64)), 64 queries, on the card; then a depth-3 segmented beam
    index (16, 16, 16) with prebuilt planes, served from its meta
    defaults, which must launch beam_eval; then an index built with
    ``--store-dtype int8 --scale-granularity bucket --compute-dtype int8``
    and served from its meta, whose banner must name that tier and which
    must launch the int8 variant;
 5. kernels vs their plain PyTorch versions on the card, at the shapes
    the main path gave them (512 queries, the full build's candidate
    capacity, every store tier (float32, bfloat16, int8 and fp8 with row
    or bucket scales, int8 compute on the int8 stores) in both gather
    forms, 3 metrics; the assignment at the build's root (1, 518,576,
    45) x 256 and level-1 (256, cap, 45) x 64 shapes, back to back and
    device only, with its variant and its 3xTF32, byte and float32
    CUDA-core bounds; 32,768
    (query, prefix) pairs over 4,096 nodes of arity 64 for beam_eval, 3
    families), with CUDA-event times and the bound of each; and the
    kernels of the LM and recsys paths at their callers' shapes: flash
    attention at stablelm-1.6b's prefill (4 x 32 heads x 4,096 into a
    4,160-position cache, dh 64, bf16, causal) and decode (one query row a
    head over the cache) and at starcoder2-15b's GQA prefill (48 / 4 heads,
    4,096, dh 128) and decode (4 x 48 / 4 heads over the cache), each
    timed back to back and device only (queued behind a sleep), with its
    achieved TFLOP/s or GB/s and share of its bound (device only), its
    ratio to SDPA both ways and the wrapper's host time a call;
    pairwise_l2 at the brute-force shape (the 512 queries x
    every embedding, float32 and bfloat16); embedding_bag at MIND's (a
    1,000,000 x 64 table, 4,096 weighted histories of 50 with repeated
    items, through ``recsys.bag_lookup(use_kernel=True)``). Each with its
    plain version's time, the PyTorch library call's (SDPA, ``torch.cdist``,
    ``F.embedding_bag``) and its bound;
 6. LM serving: ``repro.configs.stablelm_1_6b.make_full()`` (24 layers,
    1.64 B parameters, bf16, random weights from a seed) through the
    port's entry points: ``prefill`` of 4 x 4,096 tokens
    (``lm_synthetic_batch``) into a 4,160-position cache, 64 greedy
    ``decode_step``s and a cache-free ``forward``. The flash kernel's count
    is set to 0 before and read after each call and must be one launch a
    layer. The kernel path is held against the plain path (the same
    weights, every attention through the kernel's plain version) on the
    prefill's last logits and on every teacher-forced decode step, with a
    tie-aware top-1 check, and decode against the forward (the last 16
    prompt positions replayed). Prefill and decode tokens/s and ms are
    printed, and one decode step broken down: its host time and the flash
    wrapper's share of it, its device time (a ``torch.profiler`` window)
    and the flash kernels' share of it.

The line before the last is the ``{"kernels": [...]}`` JSON; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or run
from a directory without the repository's ``src/repro_torch``, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# repro.configs.lmi_protein.make_full()
FULL = dict(n_objects=518_576, n_sections=10, cutoff=50.0, arities=(256, 64),
            stop=0.01, k=30, metric="euclidean", store_dtype="bfloat16", radius_scale=1.5)
BATCH = 512  # the search_512q query batch
N_BATCHES = 4  # timed 512-query kNN batches on the main path
N_FAMILIES = 200
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM rate, non-tensor-core float32
# rate, dense int8, bfloat16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12

# |kernel - plain| limits, by metric: the kernels use the norm
# decomposition, the plain version the direct difference; Euclidean near
# self-distance takes the sqrt of the decomposition's cancellation
# (the JAX suite's end-to-end bound), the others its kernel TOL.
TOL = {"euclidean": 2e-3, "sq_euclidean": 1e-4, "cosine": 1e-5}
ASSIGN_TOL = 1e-4  # min squared distance, and the margin of a label swap
# |beam_eval - plain| child log-probs: float32 dots over d = 45 summed in
# another order, and the kmeans form |q|^2 + |c|^2 - 2 q.c (|q|^2 ~ 15)
# cancels; the same bound holds for leaf log-probs summed over 3 levels
LOGP_TOL = 1e-4

# repro.configs.lmi_protein SHAPES: the depth-3 beam serving points
D3_ARITIES = (64, 64, 64)
D3_POINTS = (
    ("search_512q_d3_beam_seg", dict(beam_width=64, node_eval="segmented", temperatures=None)),
    ("search_512q_d3_calib", dict(beam_width=(64, 16), node_eval="segmented",
                                  temperatures=(1.0, 0.8, 0.7))),
)
FAMILIES = ("kmeans", "gmm", "kmeans+logreg")
# (store dtype, scale granularity, compute dtype): the quantized phase's
# stores, and every tier phase 5 holds against its plain version
QUANT_STORES = (("int8", "row", "float32"), ("int8", "bucket", "int8"),
                ("float8_e4m3fn", "row", "float32"), ("float8_e4m3fn", "bucket", "float32"))
STORE_TIERS = (("float32", "row", "float32"), ("bfloat16", "row", "float32"),
               ("int8", "row", "float32"), ("int8", "row", "int8"),
               ("int8", "bucket", "float32"), ("int8", "bucket", "int8"),
               ("float8_e4m3fn", "row", "float32"), ("float8_e4m3fn", "bucket", "float32"))
# the integer domain computes the same exact integer dot as its plain
# version and rounds the same float epilogue steps (JAX's int-domain bound)
INT_TOL = 2e-5
MAIN_KERNELS = ("kmeans_assign", "lmi_filter_topk_desc", "lmi_filter_range_desc")
D3_KERNELS = ("kmeans_assign", "lmi_filter_topk_desc", "beam_eval")

# the LM serving phase: repro.configs.stablelm_1_6b.make_full() (24 layers,
# d_model 2048, 32 heads of 64, bfloat16) on 4 prompts of train_4k's 4,096
# tokens, a cache of 4,160 positions, 64 greedy decode steps; the last 16
# prompt positions are replayed as decode steps against the forward
LM = dict(batch=4, prompt=4096, max_len=4160, steps=64, replay=16)
# bfloat16 logits of two paths that round their activations at different
# places (kernel vs plain attention; M = 4 vs M = 16,384 products) are held
# within this share of the largest logit: about four bfloat16 steps, the
# bound of the port's CPU test against JAX in bfloat16
LM_LOGIT_TOL = 2.0 ** -5
# flash kernel vs its plain version, both rounding a float32 result to
# bfloat16: one bfloat16 step apart at most (2**-7 relative)
FLASH_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
# pairwise_l2: the JAX suite's bound (norm decomposition vs direct
# difference, float32 sums); embedding_bag: float32 sums of 50 rows in
# another order
PW_TOL = dict(rtol=1e-4, atol=1e-3)
EB_TOL = dict(rtol=1e-5, atol=1e-5)
# repro.configs.mind.make_full(): a 1,000,000-item table of 64 floats,
# histories of 50 items, and a batch of 4,096 users
MIND = dict(items=1_000_000, dim=64, hist=50, batch=4096)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn``: the calls are queued behind a
    sleep on the card, so the events time the device's work without the
    host's launch gaps (``fn`` must not synchronise)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e8))  # ~0.2 s at H100 clocks: longer than queueing reps calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds of ``fn`` over ``reps`` calls enqueued with
    no sync between them, after one warm-up call: the launch path's own
    time, while the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def step_breakdown(torch, fa_ops, fn, reps: int) -> dict:
    """One call of ``fn`` (a decode step), broken down, in ms a call: its
    host time (calls enqueued with no sync between) and the flash wrapper's
    share of it; its device time (the sum of its kernels' and copies'
    device times in a ``torch.profiler`` window) and the flash kernels'
    share of it (the source's kernels and merge, by name). The device
    numbers are None when the profiler saw no kernel."""
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inner, spent = fa_ops.flash_attention, [0.0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        spent[0] += time.perf_counter() - t0
        return out

    with mock.patch.object(fa_ops, "flash_attention", timed):
        host = host_ms(torch, fn, reps)
    spent[0] /= reps + 1  # host_ms's warm-up call ran through the wrapper too
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3 / reps
    flash = [e for e in on_dev if "flash_" in e.name]
    return dict(host_ms=host, flash_host_ms=spent[0] * 1e3, device_ms=busy or None,
                flash_device_ms=sum(e.time_range.elapsed_us() for e in flash) / 1e3 / reps
                if flash else None, device_ops=len(on_dev) / reps, flash_ops=len(flash) / reps)


def bound_ms(n_bytes: float, n_flops: float, op_rate: float = F32_FLOP_PER_S):
    """(least ms, what bounds it): bytes over HBM rate vs operations over
    their type's peak rate (float32 outside the tensor cores by default)."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tier_name(tier) -> str:
    return "/".join(tier)


def tier_keys(tier, gathers=("desc", "rows"), kinds=("topk", "range")):
    """The `lf_ops.TIER_LAUNCHES` keys a store tier's filter calls count
    under: bucket scales ride per run on the descriptor form and per row
    on the row form."""
    dtype, gran, compute = tier
    keys = []
    for g in gathers:
        if dtype in ("float32", "bfloat16"):
            scale = "none"
        else:
            scale = "run" if g == "desc" and gran == "bucket" else "row"
        keys += [f"lmi_filter_{kind}_{g}:{dtype}:{scale}:{compute}" for kind in kinds]
    return keys


def plain_filter(lf_ref, store_lib, q, rows, valid, st, compute, metric):
    """The plain (Q, C) distances of a store tier (the kernel's reference)."""
    if compute == "int8":
        return lf_ref.lmi_filter_int_ref(q, rows, valid, st.data, store_lib.row_scales(st),
                                         st.norms, metric=metric)
    return lf_ref.lmi_filter_ref(q, rows, valid, st.data, metric=metric,
                                 scales=store_lib.row_scales(st))


def plain_topk(torch, dist, k):
    """Top-k of a plain distance matrix: a stable sort, ties to the lowest slot."""
    d, s = torch.sort(dist, dim=1, stable=True)
    return d[:, :k], s[:, :k].to(torch.int32)


def launch_operands(torch, lf_ops, store_lib, st, compute, q, rows, valid, runs):
    """(queries, valid, descriptor-form kwargs, row-form kwargs) of
    `lf_ops.launch` for a store tier: the kernel's own operands, as the
    filtering entry points build them."""
    qf, v, desc = lf_ops.desc_operands(q, valid, runs)
    extra = {}
    if compute == "int8":
        qf, qscale = lf_ops._quantize_queries(qf)
        extra = dict(qscale=qscale, norms=st.norms)
    if st.scales is None:
        dq = rq = dict(scale_mode="none")
    else:
        rq = dict(scale_mode="row", scales=store_lib.row_scales(st).contiguous())
        dq = (dict(scale_mode="run",
                   scales=lf_ops._run_scales(desc[1], st.scales, st.offsets).contiguous())
              if st.scale_granularity == "bucket" else rq)
    return (qf, v, dict(desc=desc, **dq, **extra),
            dict(rows=rows.to(torch.int32).contiguous(), **rq, **extra))


def errors(got, want):
    """(max abs, max rel) difference; rel against |want|, floored at 1e-6
    so distances near 0 (a query next to its own row) stay finite."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp(min=1e-6)).max())


def counters():
    """The launch counts of every kernel wrapper of the port."""
    from repro_torch.kernels.beam_eval import ops as be_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.kernels.lmi_filter import ops as lf_ops
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops

    return (ka_ops.LAUNCHES, ka_ops.VARIANT_LAUNCHES, lf_ops.LAUNCHES, lf_ops.TIER_LAUNCHES,
            be_ops.LAUNCHES, fa_ops.LAUNCHES, pw_ops.LAUNCHES, eb_ops.LAUNCHES)


def reset() -> None:
    from repro_torch.kernels.kmeans_assign import ops as ka_ops

    for counts in counters():
        for name in counts:
            counts[name] = 0
    ka_ops.SHAPE_LAUNCHES.clear()


def read() -> dict:
    """Every kernel's count, and the per-tier filter counts that are not 0."""
    out = {}
    for counts in counters():
        out.update((k, n) for k, n in counts.items() if n or ":" not in k)
    return out


def recall(got, ref, k: int) -> float:
    """Mean share of each row of ``ref`` (ids, -1 == none) found in ``got``."""
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.mean([len(np.intersect1d(got[i][got[i] >= 0], ref[i][ref[i] >= 0])) / k
                          for i in range(ref.shape[0])]))


def ranking_agrees(torch, n_leaves, order_a, logp_a, order_b, logp_b):
    """(same leaf sets, max |logp diff| by position, max |logp_a of the
    leaf b ranks at a position - logp_a at that position|): two rankings
    are equal modulo ties when the sets match and both numbers are small."""
    same = bool(torch.equal(torch.sort(order_a, dim=1).values, torch.sort(order_b, dim=1).values))
    pos = float((logp_a - logp_b).abs().max())
    full = torch.full((order_a.shape[0], n_leaves), float("nan"), device=logp_a.device)
    full.scatter_(1, order_a, logp_a)
    tie = float((full.gather(1, order_b) - logp_a).abs().max())
    return same, pos, tie


def fingerprint(index) -> tuple:
    """(empty buckets, the first 12 hex digits of the SHA-256 of every
    level's centroid bytes): two builds of one index agree on both."""
    import hashlib

    h = hashlib.sha256()
    for level in index.levels:
        h.update(level["centroids"].float().contiguous().cpu().numpy().tobytes())
    return int((index.bucket_sizes() == 0).sum()), h.hexdigest()[:12]


def same_index(torch, a, b) -> bool:
    """Every level's centroids, the bucket offsets and the ids, bit for bit."""
    return (len(a.levels) == len(b.levels)
            and all(torch.equal(la["centroids"], lb["centroids"])
                    for la, lb in zip(a.levels, b.levels))
            and torch.equal(a.bucket_offsets, b.bucket_offsets)
            and torch.equal(a.sorted_ids, b.sorted_ids))


BUILD_STAGES = ("seeding", "assignment", "sums and repair", "loop and host syncs", "padding",
                "children")


def build_breakdown(torch, emb, arities, dev):
    """The main-path build again from SEED, with its functions timed from
    here (each call between two synchronisations; the package has no
    timers): per level, k-means++ seeding, the Lloyd assignments (the
    kmeans_assign wrapper), the rest of each Lloyd step (one-hot sums,
    empty-cluster repair), the rest of the Lloyd loop (shift, freezing,
    the host sync of each iteration), `_pad_groups` and `_assign_children`.
    -> (index, [per-level record], total seconds, level 1's padded points)."""
    from unittest import mock

    from repro_torch.core import kmeans, lmi
    from repro_torch.kernels.kmeans_assign import ops as ka_ops

    levels, cur = [], [None]
    kept = {}

    def new_level():
        levels.append(dict({st: 0.0 for st in BUILD_STAGES}, fit=0.0, calls=0, shapes=set()))
        cur[0] = levels[-1]

    def timed(stage, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            cur[0][stage] += time.perf_counter() - t0
            return out
        return run

    inner_assign, inner_fit, inner_many, inner_pad = (
        ka_ops.kmeans_assign_with_dist, kmeans.fit, kmeans.fit_many, lmi._pad_groups)

    def assign(x, c):  # the Lloyd step's: x (G, n, d), c (G, k, d)
        cur[0]["calls"] += 1
        cur[0]["shapes"].add((tuple(x.shape), c.shape[-2]))
        return timed("assignment", inner_assign)(x, c)

    def fit(gen, x, k, **kw):
        new_level()
        cur[0].update(groups=1, cap=x.shape[0], pad_share=0.0)
        st = timed("fit", inner_fit)(gen, x, k, **kw)
        cur[0]["iterations"] = int(st.n_iter)
        return st

    def fit_many(gen, xs, ws, k, **kw):
        cur[0].update(groups=xs.shape[0], cap=xs.shape[1],
                      pad_share=1.0 - float(ws.sum()) / ws.numel())
        if len(levels) == 2:
            kept["level1_points"] = xs
        st = timed("fit", inner_many)(gen, xs, ws, k, **kw)
        cur[0]["iterations"] = int(st.n_iter.max())
        return st

    def pad_groups(*args):
        new_level()
        return timed("padding", inner_pad)(*args)

    patches = [mock.patch.object(ka_ops, "kmeans_assign_with_dist", assign),
               mock.patch.object(kmeans, "fit", fit),
               mock.patch.object(kmeans, "fit_many", fit_many),
               mock.patch.object(kmeans, "_plusplus_init", timed("seeding", kmeans._plusplus_init)),
               mock.patch.object(kmeans, "_lloyd_step_many",
                                 timed("sums and repair", kmeans._lloyd_step_many)),
               mock.patch.object(kmeans, "_lloyd", timed("loop and host syncs", kmeans._lloyd)),
               mock.patch.object(lmi, "_pad_groups", pad_groups),
               mock.patch.object(lmi, "_assign_children",
                                 timed("children", lmi._assign_children))]
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = lmi.build(SEED, emb, arities=arities, model_type="kmeans", device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    for lv in levels:  # nested timers: each stage net of the ones inside it
        lv["loop and host syncs"] -= lv["sums and repair"]
        lv["sums and repair"] -= lv["assignment"]
    return index, levels, total, kept.get("level1_points")


def depth3_phase(torch, np, index, queries, dev):
    """Phase 3: the depth-3 beam serving points over the main path's
    embeddings. -> (beam_eval records by family, the phase's launches)."""
    from unittest import mock

    from repro_torch.core import filtering, lmi
    from repro_torch.core import planes as planes_lib
    from repro_torch.core import store as store_lib
    from repro_torch.kernels.beam_eval import ops as be_ops, ref as be_ref
    from repro_torch.kernels.lmi_filter import ops as lf_ops

    k, stop, metric = FULL["k"], FULL["stop"], FULL["metric"]
    reset()
    t0 = time.perf_counter()
    index3 = lmi.build(SEED, index.sorted_embeddings, arities=D3_ARITIES, model_type="kmeans",
                       device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_obj = index3.n_objects
    check(np.array_equal(np.sort(index3.sorted_ids.cpu().numpy()), np.arange(n_obj)),
          "depth-3: an object is missing from the buckets or appears twice")
    store3 = store_lib.from_lmi(index3, FULL["store_dtype"])
    planes = {name: planes_lib.from_lmi(index3, kw["temperatures"]) for name, kw in D3_POINTS}
    sizes = index3.bucket_sizes().cpu().numpy()
    print(f"depth-3 build {'x'.join(map(str, D3_ARITIES))} over {n_obj} embeddings: "
          f"{t_build:.2f}s; buckets mean {sizes.mean():.2f} max {sizes.max()} "
          f"empty {(sizes == 0).sum()}, centroids sha256 {fingerprint(index3)[1]}; planes "
          + ", ".join(f"{n} {p.nbytes() / 2**20:.1f} MB" for n, p in planes.items()), flush=True)

    phase_launches = read()
    q = queries[:BATCH]
    nq = q.shape[0]
    stop_count, cap = lmi.query_plan_params(index3, stop)
    offsets, bsizes = index3.bucket_offsets, index3.bucket_sizes()
    mt = index3.model_type
    beam_inputs = None
    for name, kw in D3_POINTS:
        pl = planes[name]

        def knn3(qb, kw=kw, pl=pl):
            return filtering.knn_query(index3, qb, k=k, stop_condition=stop, metric=metric,
                                       store=store3, planes=pl, **kw)

        reset()
        ids0, d0 = knn3(q)  # warm-up batch, checked below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(1, N_BATCHES + 1):
            knn3(queries[b * BATCH:(b + 1) * BATCH])
        torch.cuda.synchronize()
        t_query = time.perf_counter() - t0
        pt = read()
        for kname, n in pt.items():
            phase_launches[kname] = phase_launches.get(kname, 0) + n
        qps = N_BATCHES * BATCH / t_query
        check(tuple(ids0.shape) == (BATCH, k) and bool(ids0[:, 0].ge(0).all()),
              f"{name}: kNN shape or a query with no neighbour")
        check(bool(torch.isfinite(d0[ids0 >= 0]).all()), f"{name}: non-finite kNN distance")
        for kname in ("beam_eval", "lmi_filter_topk_desc"):
            check(pt[kname] > 0, f"{name}: kernel {kname} was not launched")

        # the stages of one batch, replayed step by step with CUDA-event times
        widths = lmi.normalize_beam_widths(kw["beam_width"], 3)
        temps = lmi.normalize_temperatures(kw["temperatures"], 3)
        check(widths[0] >= D3_ARITIES[0], "the replay assumes a dense level 1")

        def dense():
            acc = lmi._node_log_proba(mt, index3.levels[0], q, temps[0])
            child = lmi._node_log_proba(mt, index3.levels[1], q, temps[1])
            return (acc.T[:, :, None] + child).permute(1, 0, 2).reshape(nq, -1)

        acc1 = dense()

        def prune():
            acc, sel = lmi._top(acc1, widths[1])
            return acc, sel, be_ops.node_scores(q, sel, pl.levels[1], mt, temperature=temps[2])

        accp, selp, child = prune()
        acc2 = (accp[:, :, None] + child).reshape(nq, -1)
        prefix2 = (selp[:, :, None] * D3_ARITIES[2]
                   + torch.arange(D3_ARITIES[2], device=dev)[None, None, :]).reshape(nq, -1)

        def final_sort():
            _v, sel = lmi._top(acc2, acc2.shape[-1])
            return torch.gather(prefix2, 1, sel)

        order = final_sort()
        r_order, r_logp = lmi.beam_leaf_ranking(index3, q, kw["beam_width"],
                                                node_eval="segmented",
                                                temperatures=kw["temperatures"], planes=pl)
        check(bool(torch.equal(order, r_order)), f"{name}: the stage replay left the path")
        sz, visited = lmi._visited_cut(order, bsizes, stop_count)
        rows, valid, _nc = lmi.extract_rows(order, visited, offsets, cap)
        runs = lmi.BucketRuns(starts=offsets[order].to(torch.int32),
                              lengths=torch.where(visited, sz, 0).to(torch.int32))
        ops_in = lf_ops.desc_operands(q, valid, runs)
        stages = {
            "dense levels": dense,
            "prune + node_scores": prune,
            "node_scores kernel": lambda: be_ops.node_scores(q, selp, pl.levels[1], mt,
                                                             temperature=temps[2]),
            "final sort": final_sort,
            "rank + cut": lambda: lmi._visited_cut(order, bsizes, stop_count),
            "extract": lambda: lmi.extract_rows(order, visited, offsets, cap),
            "descriptors": lambda: lf_ops.desc_operands(q, valid, runs),
            "filter": lambda: lf_ops.launch(ops_in[0], store3.data, ops_in[1], k=k,
                                            metric=metric, desc=ops_in[2]),
            "knn_query": lambda: knn3(q),
        }
        stage_ms = {sname: (time_ms(torch, fn, 10), device_ms(torch, fn, 10))
                    for sname, fn in stages.items()}

        # recall@30 vs exact enumeration (same temperatures) and vs brute force
        ex_ids, _exd = filtering.knn_query(index3, q, k=k, stop_condition=stop, metric=metric,
                                           store=store3, temperatures=kw["temperatures"])
        bf_rows, _bfd = filtering.brute_force_knn(q, index3.sorted_embeddings, k, metric=metric)
        bf = index3.sorted_ids[bf_rows.long()]
        got = ids0.cpu().numpy()
        rec_exact, rec_bf = recall(got, ex_ids.cpu().numpy(), k), recall(got, bf.cpu().numpy(), k)

        # the kernel against the plain segmented and the gather paths
        qs = q * be_ops._f32(temps[2] ** -0.5).to(dev) if mt == "kmeans" and temps[2] != 1.0 else q
        plain_child = be_ref.node_scores_ref(qs, selp, pl.levels[1], mt)
        lerr = float((child - plain_child).abs().max())
        check(lerr <= LOGP_TOL, f"{name}: beam_eval log-probs differ from plain by {lerr}")

        def plain_node_scores(queries_, prefix_, planes_, model_type, use_kernel=False,
                              interpret=None, temperature=1.0):
            qf = queries_.float()
            if model_type == "kmeans" and temperature != 1.0:
                qf = qf * be_ops._f32(temperature ** -0.5).to(qf.device)
            return be_ref.node_scores_ref(qf, prefix_, planes_, model_type)

        with mock.patch.object(be_ops, "node_scores", plain_node_scores):
            p_order, p_logp = lmi.beam_leaf_ranking(index3, q, kw["beam_width"],
                                                    node_eval="segmented",
                                                    temperatures=kw["temperatures"], planes=pl)
            p_ids, p_d = knn3(q)
        g_order, g_logp = lmi.beam_leaf_ranking(index3, q, kw["beam_width"], node_eval="gather",
                                                temperatures=kw["temperatures"])
        g_ids, g_d = filtering.knn_query(index3, q, k=k, stop_condition=stop, metric=metric,
                                         store=store3, beam_width=kw["beam_width"],
                                         node_eval="gather", temperatures=kw["temperatures"])
        cmp = {}
        for other, (o_order, o_logp, o_ids, o_d) in (
                ("plain", (p_order, p_logp, p_ids, p_d)), ("gather", (g_order, g_logp, g_ids, g_d))):
            same, pos, tie = ranking_agrees(torch, index3.n_leaves, r_order, r_logp, o_order, o_logp)
            agree = float(filtering.knn_agree(ids0.cpu(), d0.cpu(), o_ids.cpu(), o_d.cpu(),
                                              atol=TOL["euclidean"]).mean())
            check(same, f"{name}: the beam's leaf sets differ from the {other} path")
            check(pos <= LOGP_TOL and tie <= LOGP_TOL,
                  f"{name}: ranking differs from the {other} path beyond ties ({pos}, {tie})")
            check(agree >= 0.99, f"{name}: kNN agrees with the {other} path on {agree:.4f}")
            cmp[other] = (pos, tie, agree)
        print(f"{name}: {qps:.0f} QPS over {N_BATCHES}x{BATCH} | launches {pt} | "
              f"recall@{k} vs exact {rec_exact:.4f}, vs brute force {rec_bf:.4f} | "
              f"beam_eval vs plain |dlogp| {lerr:.2e}; "
              + "; ".join(f"vs {o}: same leaf sets, |dlogp| {a:.2e}, ties {b:.2e}, "
                          f"kNN agreement {c:.4f}" for o, (a, b, c) in cmp.items()), flush=True)
        host_q, dev_q = stage_ms["knn_query"]
        print(f"{name} stages, ms per 512-query batch (back to back / device only): "
              + " | ".join(f"{n} {h:.4f} / {v:.4f}" for n, (h, v) in stage_ms.items())
              + f" | device idle share of knn_query {1.0 - dev_q / host_q:.3f}", flush=True)
        check(rec_bf > 0.5, f"{name}: recall@{k} vs brute force {rec_bf} is implausibly low")
        if beam_inputs is None:  # the P = 32,768 frontier of the beam-64 point
            beam_inputs = (selp, pl.levels[1])
    for kname in D3_KERNELS:
        check(phase_launches[kname] > 0, f"kernel {kname} was not launched on the depth-3 path")

    # ---- beam_eval vs its plain version per family, at the beam-64 shapes
    selp, kplanes = beam_inputs
    p_pairs, f_width = selp.numel(), selp.shape[1]
    n_nodes, arity, d = kplanes.mats[0].shape
    rng = np.random.default_rng(7)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    fam_planes = {
        "kmeans": kplanes,
        "gmm": be_ops.family_planes("gmm", {
            "means": rand(n_nodes, arity, d), "variances": rand(n_nodes, arity, d, lo=0.2),
            "log_weights": torch.log_softmax(rand(n_nodes, arity), dim=-1)}),
        "kmeans+logreg": be_ops.family_planes("kmeans+logreg", {
            "w": rand(n_nodes, d, arity, lo=-1.0), "b": rand(n_nodes, arity, lo=-1.0)}),
    }
    records = {}
    for fam in FAMILIES:
        fp = fam_planes[fam]
        got = be_ops.node_scores(q, selp, fp, fam)
        want = be_ref.node_scores_ref(q, selp, fp, fam)
        err = float((got - want).abs().max())
        check(err <= LOGP_TOL, f"beam_eval {fam}: |err| {err} > {LOGP_TOL}")
        node_s, order = be_ops.sort_pairs(selp)
        t_host = time_ms(torch, lambda: be_ops.node_scores(q, selp, fp, fam), 20)
        t_k = device_ms(torch, lambda: be_ops.node_scores(q, selp, fp, fam), 20)
        t_sort = device_ms(torch, lambda: be_ops.sort_pairs(selp), 20)
        t_launch = device_ms(torch, lambda: be_ops.launch_sorted(q, node_s, order, f_width, fp,
                                                                  fam), 20)
        t_p = device_ms(torch, lambda: be_ref.node_scores_ref(q, selp, fp, fam), 5)
        st = be_ops.segment_stats(selp.cpu().numpy(), fam, arity, d, n_nodes,
                                  prebuilt_planes=True)
        n_mats, n_vecs = len(fp.mats), len(fp.vecs)
        # each touched node's planes once, the queries, one int32 node id per
        # pair, the (P, arity) output
        n_bytes = (st["n_touched_nodes"] * (n_mats * arity * d + n_vecs * arity) * 4
                   + q.numel() * 4 + p_pairs * 4 + p_pairs * arity * 4)
        b = bound_ms(n_bytes, 2.0 * p_pairs * arity * d * n_mats)
        records[fam] = dict(ms=t_k, plain_ms=t_p, bound_ms=b[0], bound_by=b[1], max_abs_err=err,
                            kernel_ms=t_launch, sort_ms=t_sort, host_ms=t_host,
                            n_touched_nodes=st["n_touched_nodes"],
                            n_param_loads=st["n_param_loads"],
                            segmented_bytes=st["segmented_bytes"], gather_bytes=st["gather_bytes"])
        print(f"  beam_eval {fam:13s} P={p_pairs} (F={f_width}) N={n_nodes} arity={arity} d={d}: "
              f"{t_k:.4f} ms on the device = sort {t_sort:.4f} + kernel {t_launch:.4f} "
              f"({t_host:.4f} back to back) (plain {t_p:.3f}, bound {b[0]:.4f} by {b[1]}) "
              f"err {err:.1e} | touched nodes {st['n_touched_nodes']}, block loads "
              f"{st['n_param_loads']}, segmented {st['segmented_bytes'] / 1e6:.1f} MB vs "
              f"gather {st['gather_bytes'] / 1e6:.1f} MB", flush=True)
    return records, phase_launches


def assign_phase(torch, dev, ka_ops, ka_ref, cases, build_levels, build_launches) -> dict:
    """kmeans_assign at the build's shapes: held against its plain version
    (min d2 within ASSIGN_TOL, a label swap only between centroids within
    ASSIGN_TOL by direct difference), timed back to back and device only,
    with the variant the checked call launched (it must be the tensor
    cores'), the main-path build's launches at that shape (the wrapper's
    counts by shape, ``build_launches``), and its bounds: 3xTF32
    operations at the TF32 peak or bytes, and the float32 CUDA-core bound
    (what the one-thread-a-point design could reach). -> {case: record}."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, x, c in cases:
        g, n, d = x.shape
        k = c.shape[1]
        before = dict(ka_ops.VARIANT_LAUNCHES)
        kl, km = ka_ops.kmeans_assign_with_dist(x, c)
        ran = [v.split(":")[1] for v, m in ka_ops.VARIANT_LAUNCHES.items() if m > before[v]]
        check(ran == ["tensor_core"], f"kmeans_assign {name}: the checked call launched {ran}")
        rl, rm = ka_ref.kmeans_assign_ref(x, c)
        aerr, arel = errors(km, rm)
        check(aerr <= ASSIGN_TOL, f"kmeans_assign {name}: min d2 |err| {aerr}")
        swapped = kl != rl
        if bool(swapped.any()):  # a label swap is fine only between near-equal centroids
            def dist(lab):
                cl = torch.gather(c, 1, lab.long()[..., None].expand(g, n, d))
                return ((x - cl) ** 2).sum(-1)[swapped]
            gap = float((dist(kl) - dist(rl)).abs().max())
            check(gap <= ASSIGN_TOL, f"kmeans_assign {name}: labels differ beyond ties ({gap})")
        run = lambda: ka_ops.kmeans_assign_with_dist(x, c)
        ms, dev_ms = time_ms(torch, run, 20), device_ms(torch, run, 20)
        plain_ms = time_ms(torch, lambda: ka_ref.kmeans_assign_ref(x, c), 5)
        flops, n_bytes = 2.0 * g * n * k * d, g * n * d * 4 + g * k * d * 4 + g * n * 8
        bnd = bound_ms(n_bytes, 3 * flops, TF32_FLOP_PER_S)
        p = ka_ops.plan(g, n, k, d, sms)
        at_shape = {v: m for (v, *shape), m in build_launches.items() if shape == [g, n, k, d]}
        check(set(at_shape) == {"tensor_core"},
              f"kmeans_assign {name}: the main-path build launched {at_shape} at this shape")
        launches = at_shape.get("tensor_core", 0)
        pad = next((lv["pad_share"] for lv in build_levels if ((g, n, d), k) in lv["shapes"]),
                   0.0)
        out[name] = dict(max_abs_err=aerr, max_rel_err=arel, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                         bound_bytes_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                         bound_f32_ms=flops / F32_FLOP_PER_S * 1e3,
                         variant=ran[0], chunk=p.chunk, grid=p.grid[0], shape=[g, n, k, d],
                         launches_at_shape=launches, padding_rows=pad,
                         label_swaps=int(swapped.sum()))
        print(f"  kmeans_assign {name} ({g}, {n}, {d}) x {k} [{ran[0]}, chunk {p.chunk}, "
              f"{p.grid[0]} blocks]: {ms:.4f} ms back to back, {dev_ms:.4f} device only (plain "
              f"{plain_ms:.3f}; bound {bnd[0]:.4f} by {bnd[1]} at 3xTF32, bytes "
              f"{out[name]['bound_bytes_ms']:.4f}, float32 CUDA cores "
              f"{out[name]['bound_f32_ms']:.4f}) err {aerr:.1e} rel {arel:.1e}, label swaps "
              f"{int(swapped.sum())} | {launches} launches at this shape in the main-path build, "
              f"padding "
              f"rows {pad:.1%}", flush=True)
    return out


def filter_bytes(tier, item, d, nq, shapes, form: str, k: int) -> int:
    """Bytes a filter launch must move at least: each distinct touched row
    once (1 B an element in the 1-byte tiers), with its scale (row mode) or
    one scalar per live run (run mode) and its norm (int compute); the
    queries; the gather's own operands (descriptor form: each query's run
    count and live descriptors and the valid flag of each covered slot;
    row form: every valid flag and the row of each valid slot); the output
    (top-k pairs, or the (Q, C) matrix when k == 0)."""
    dtype, gran, compute = tier
    n = shapes["n_touched"] * d * item
    if dtype in ("int8", "float8_e4m3fn"):
        n += 4 * (shapes["n_runs"] if form == "desc" and gran == "bucket" else shapes["n_touched"])
    if compute == "int8":
        n += 4 * shapes["n_touched"] + nq * d + nq * 4
    else:
        n += nq * d * 4
    if form == "desc":
        n += nq * 4 + 12 * shapes["n_runs"] + shapes["covered"]
    else:
        n += nq * shapes["cap"] + 4 * shapes["n_valid"]
    return n + (nq * k * 8 if k else nq * shapes["cap"] * 4)


def filter_ops(tier, shapes, d):
    """(operations, their peak rate) of a filter launch: the dot and |c|^2
    in float32 (4 per gathered element), or the int8 dot (2 per element)."""
    if tier[2] == "int8":
        return 2 * shapes["covered"] * d, INT8_OP_PER_S
    return 4 * shapes["covered"] * d, F32_FLOP_PER_S


def quantized_phase(torch, np, index, cpu_index, queries, search, bf, shapes):
    """Phase 2b: the quantized stores over the main path's index and query
    batches. -> ({tier name: record}, the phase's launches)."""
    from repro_torch.core import filtering
    from repro_torch.core import store as store_lib
    from repro_torch.kernels.lmi_filter import ops as lf_ops, ref as lf_ref

    k, stop, metric = FULL["k"], FULL["stop"], FULL["metric"]
    cand_ids, rows, valid, runs = search
    q = queries[:BATCH]
    f32_ids, _ = filtering.knn_query(index, q, k=k, stop_condition=stop, metric=metric)
    f32_ids = f32_ids.cpu().numpy()
    records, phase_launches = {}, {}
    for tier in QUANT_STORES:
        dtype, gran, compute = tier
        name = tier_name(tier)
        st = store_lib.from_lmi(index, dtype, scale_granularity=gran)
        torch.cuda.synchronize()
        cst = store_lib.from_lmi(cpu_index, dtype, scale_granularity=gran)
        n_code = int((st.data.cpu().view(torch.uint8) != cst.data.view(torch.uint8)).sum())
        n_scale = int((st.scales.cpu().view(torch.int32) != cst.scales.view(torch.int32)).sum())
        n_norm = 0 if cst.norms is None else int((st.norms.cpu() != cst.norms).sum())

        def knn(qb, st=st, compute=compute):
            return filtering.knn_query(index, qb, k=k, stop_condition=stop, metric=metric,
                                       store=st, compute_dtype=compute)

        reset()
        ids0, d0 = knn(q)  # warm-up batch, checked below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(1, N_BATCHES + 1):
            knn(queries[b * BATCH:(b + 1) * BATCH])
        torch.cuda.synchronize()
        t_query = time.perf_counter() - t0
        rq = filtering.range_query(index, q, 0.5, stop_condition=stop,
                                   radius_scale=FULL["radius_scale"], store=st,
                                   compute_dtype=compute)
        # row-only callers: the filter entry points without the search's runs
        rk_d, rk_s = filtering.filter_topk(st, q, rows, valid, k, metric=metric,
                                           compute_dtype=compute)
        rk_r = filtering.filter_range(st, q, rows, valid, metric=metric, compute_dtype=compute)
        torch.cuda.synchronize()
        pt = read()
        for kname, n in pt.items():
            phase_launches[kname] = phase_launches.get(kname, 0) + n
        for key in tier_keys(tier):
            check(pt.get(key, 0) > 0, f"{name}: kernel tier {key} was not launched")
        check(tuple(ids0.shape) == (BATCH, k) and bool(ids0[:, 0].ge(0).all()),
              f"{name}: kNN shape or a query with no neighbour")
        check(bool(torch.isfinite(d0[ids0 >= 0]).all()), f"{name}: non-finite kNN distance")

        # kernel vs plain on the same search, modulo distance ties
        pdist = plain_filter(lf_ref, store_lib, q, rows, valid, st, compute, metric)
        pd, ps = plain_topk(torch, pdist, k)
        pids = torch.where(pd < 1e37, torch.gather(cand_ids, 1, ps.long()), -1)
        tol = TOL[metric]
        for label, (gi, gd) in (("kNN", (ids0, d0)), (
                "row-gather top-k",
                (torch.where(rk_d < 1e37, torch.gather(cand_ids, 1, rk_s.clamp(min=0).long()), -1),
                 rk_d))):
            agree = filtering.knn_agree(gi.cpu(), gd.cpu(), pids.cpu(), pd.cpu(), atol=tol)
            check(bool(agree.all()),
                  f"{name}: {label} differs from the plain path on {int((~agree).sum())} queries")
        fin = pdist < 1e37
        for label, got in (("range", rq.distances), ("row-gather range", rk_r)):
            check(bool(torch.equal(got < 1e37, fin)), f"{name}: {label} valid slots differ")
            err = float((got[fin] - pdist[fin]).abs().max())
            check(err <= tol, f"{name}: {label} differs from the plain path by {err}")

        host_ms = time_ms(torch, lambda: knn(q), 10)
        dev_ms = device_ms(torch, lambda: knn(q), 10)
        qf, v, dkw, _rkw = launch_operands(torch, lf_ops, store_lib, st, compute, q, rows, valid,
                                           runs)
        t_k = time_ms(torch, lambda: lf_ops.launch(qf, st.data, v, k=k, metric=metric, **dkw), 20)
        t_p = time_ms(torch, lambda: plain_topk(torch, plain_filter(
            lf_ref, store_lib, q, rows, valid, st, compute, metric), k), 5)
        ops, rate = filter_ops(tier, shapes, index.dim)
        b = bound_ms(filter_bytes(tier, 1, index.dim, BATCH, shapes, "desc", k), ops, rate)
        got = ids0.cpu().numpy()
        rec_bf, rec_f32 = recall(got, bf, k), recall(got, f32_ids, k)
        records[name] = dict(qps=N_BATCHES * BATCH / t_query, store_mb=st.nbytes() / 2**20,
                             knn_ms=host_ms, knn_device_ms=dev_ms, recall_bf=rec_bf,
                             recall_f32=rec_f32, filter_ms=t_k, plain_ms=t_p, bound_ms=b[0],
                             code_diffs=(n_code, n_scale, n_norm))
        print(f"quantized {name}: store {st.nbytes() / 2**20:.2f} MB | "
              f"{N_BATCHES * BATCH / t_query:.0f} QPS over {N_BATCHES}x{BATCH} | knn_query "
              f"{host_ms:.4f} ms back to back, {dev_ms:.4f} device only | recall@{k} vs brute "
              f"force {rec_bf:.4f}, vs the float32 store {rec_f32:.4f} | filter kernel "
              f"{t_k:.4f} ms (plain {t_p:.3f}, bound {b[0]:.4f} by {b[1]}) | kernel == plain "
              f"modulo ties (both gathers) | card vs CPU differing codes {n_code}, scales "
              f"{n_scale}, norms {n_norm} | launches "
              + ", ".join(f"{key} {pt.get(key, 0)}" for key in tier_keys(tier)), flush=True)
    return records, phase_launches


def held_close(got, want, rtol: float, atol: float, what: str) -> float:
    """max |got - want|, after checking |got - want| <= atol + rtol |want|
    everywhere (float32 comparison)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool((diff <= atol + rtol * want.abs()).all()),
          f"{what}: kernel differs from its plain version (max |err| {float(diff.max())})")
    return float(diff.max())


def top1_agree(torch, got, want, err: float) -> tuple:
    """(rows whose top-1 token is the same, rows where it differs but the
    plain path's top-1 / top-2 margin is within ``err``, rows that differ
    beyond it)."""
    top2 = torch.topk(want, 2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= err
    same = got.argmax(-1) == want.argmax(-1)
    return int(same.sum()), int((~same & tie).sum()), int((~same & ~tie).sum())


def lm_phase(torch, np, dev, quick: bool):
    """Phase 6: serve stablelm-1.6b through the port's entry points
    (prefill, greedy decode_step, a cache-free forward), the flash kernel's
    count set to 0 before and read after each call; hold the kernel path
    against the plain path on the same weights, and decode against the
    forward. -> (record, the phase's flash launches)."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import stablelm_1_6b
    from repro_torch.data.pipeline import lm_synthetic_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.models import transformer as T

    cfg = stablelm_1_6b.make_full()
    if quick:
        cfg = dataclasses.replace(cfg, n_layers=2)
    n_layers, B, P, S = cfg.n_layers, LM["batch"], LM["prompt"], LM["max_len"]
    counts = fa_ops.LAUNCHES

    def launched(fn):
        """(fn's result, flash launches during it, its seconds)"""
        counts["flash_attention"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, counts["flash_attention"], time.perf_counter() - t0

    t0 = time.perf_counter()
    model = T.init_params(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tokens = torch.from_numpy(lm_synthetic_batch(cfg.vocab_size, B, P)(SEED, 0)["tokens"]).to(dev)
    reset()
    _, n_warm, _ = launched(lambda: T.prefill(cfg, model, tokens, S, full_logits=False))
    (logits, cache), n_pre, t_pre = launched(
        lambda: T.prefill(cfg, model, tokens, S, full_logits=False))
    check(n_warm == n_pre == n_layers, f"prefill launched the flash kernel {n_pre} times, "
                                       f"not once per layer ({n_layers})")
    check(tuple(logits.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "prefill logits: shape or a non-finite value")

    # greedy decoding, the kernel's count read after every step
    tok = logits.argmax(-1, keepdim=True)
    gen, step_logits, per_step = [tok], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM["steps"]):
        counts["flash_attention"] = 0
        before = cache
        lg, cache = T.decode_step(cfg, model, tok, cache)
        per_step.append(counts["flash_attention"])
        step_logits.append(lg)
        tok = lg.argmax(-1, keepdim=True)
        gen.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    # the last step again (it rewrites the same cache position): back to
    # back, and device only (queued behind a sleep), for the idle share
    step_host = time_ms(torch, lambda: T.decode_step(cfg, model, gen[-2], before), 10)
    step_dev = device_ms(torch, lambda: T.decode_step(cfg, model, gen[-2], before), 10)
    # the same step broken down: host time, the flash wrapper's share of it,
    # device busy time from the profiler, the flash kernels' share of it
    brk = step_breakdown(torch, fa_ops, lambda: T.decode_step(cfg, model, gen[-2], before), 5)
    del before
    check(all(n == n_layers for n in per_step),
          f"decode steps launched the flash kernel {sorted(set(per_step))} times, not {n_layers}")
    check(cache.length == P + LM["steps"], "the cache did not advance one position a step")
    check(all(bool(torch.isfinite(lg).all()) for lg in step_logits), "non-finite decode logits")
    del cache

    (full, _), n_fwd, t_fwd = launched(lambda: T.forward(cfg, model, tokens))
    check(n_fwd == n_layers, f"forward launched the flash kernel {n_fwd} times")
    check(tuple(full.shape) == (B, P, cfg.vocab_size) and bool(torch.isfinite(full).all()),
          "forward logits: shape or a non-finite value")

    def held(got, want, what):
        """max |got - want|, checked against LM_LOGIT_TOL of want's largest
        logit, and the tie-aware top-1 agreement."""
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        agree = top1_agree(torch, got, want, err)
        check(err <= LM_LOGIT_TOL * scale,
              f"{what}: |logits diff| {err} > {LM_LOGIT_TOL} x {scale}")
        check(agree[2] == 0, f"{what}: top-1 differs beyond the error on {agree[2]} rows")
        return err, scale, agree

    fwd_err = held(logits, full[:, -1], "prefill vs forward, last position")

    # the plain path on the same weights: every attention through the
    # kernel's plain version; prefill, then teacher-forced decoding on the
    # kernel path's tokens
    def plain_flash(q, k, v, causal=True, q_offset=None, kv_len=None):
        return fa_ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                          kv_len=kv_len)

    with mock.patch.object(fa_ops, "flash_attention", plain_flash):
        (plogits, pcache), n_plain, t_plain = launched(
            lambda: T.prefill(cfg, model, tokens, S, full_logits=False))
        check(n_plain == 0, "the plain path launched the flash kernel")
        plain_errs = [held(logits, plogits, "prefill, kernel vs plain")]
        for i in range(LM["steps"]):
            plg, pcache = T.decode_step(cfg, model, gen[i], pcache)
            plain_errs.append(held(step_logits[i], plg, f"decode step {i}, kernel vs plain"))
    del pcache, plogits

    # decode against the forward: the last `replay` prompt positions again,
    # as decode steps after a prefill of the rest
    r = LM["replay"]
    (c_logits, ccache), _, _ = launched(
        lambda: T.prefill(cfg, model, tokens[:, :P - r], S, full_logits=False))
    replay_errs = [held(c_logits, full[:, P - r - 1], "prefill vs forward")]
    for i in range(r):
        lg, ccache = T.decode_step(cfg, model, tokens[:, P - r + i:P - r + i + 1], ccache)
        replay_errs.append(held(lg, full[:, P - r + i], f"replayed step {i} vs forward"))
    del ccache, full

    gen_tokens = torch.cat(gen, dim=1)
    rec = dict(
        config=cfg.name, layers=n_layers, params=cfg.param_count(), batch=B, prompt=P,
        max_len=S, steps=LM["steps"], init_s=t_init, prefill_ms=t_pre * 1e3,
        prefill_tok_s=B * P / t_pre, plain_prefill_ms=t_plain * 1e3,
        decode_ms_per_step=t_dec * 1e3 / LM["steps"], decode_tok_s=B * LM["steps"] / t_dec,
        decode_step_ms=step_host, decode_step_device_ms=step_dev,
        decode_step_breakdown=brk,
        forward_ms=t_fwd * 1e3,
        launches=dict(prefill=n_pre, forward=n_fwd, decode_per_step=per_step[0]),
        kernel_vs_plain_max_err=max(e[0] for e in plain_errs),
        kernel_vs_plain_logit_scale=max(e[1] for e in plain_errs),
        kernel_vs_plain_top1=[sum(e[2][j] for e in plain_errs) for j in range(3)],
        decode_vs_forward_max_err=max(e[0] for e in replay_errs),
        prefill_vs_forward_err=fwd_err[0],
        distinct_generated=int(gen_tokens.unique().numel()),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"LM {cfg.name} ({n_layers} layers, {cfg.param_count():,} params, bf16, random "
          f"weights, seed {SEED}): init {t_init:.2f}s | prefill {B}x{P} into {S}: "
          f"{t_pre * 1e3:.1f} ms = {B * P / t_pre:,.0f} tokens/s (plain path "
          f"{t_plain * 1e3:.1f} ms) | decode {LM['steps']} greedy steps: "
          f"{rec['decode_ms_per_step']:.2f} ms/step = {rec['decode_tok_s']:,.0f} tokens/s (last "
          f"step {step_host:.2f} ms back to back, {step_dev:.2f} device only: idle share "
          f"{1.0 - step_dev / step_host:.3f}) | "
          f"forward {B}x{P}: {t_fwd * 1e3:.1f} ms | flash launches: prefill {n_pre}, forward "
          f"{n_fwd}, every decode step {per_step[0]}", flush=True)
    busy, fl = brk["device_ms"], brk["flash_device_ms"]
    print(f"LM decode step breakdown (the last step): host {brk['host_ms']:.3f} ms enqueued, of "
          f"it the flash wrapper {brk['flash_host_ms']:.3f} ms "
          f"({brk['flash_host_ms'] / n_layers * 1e3:.1f} us a call) | device busy "
          + (f"{busy:.3f} ms (profiler, {brk['device_ops']:.0f} kernels and copies), of it "
             f"flash {fl} ms ({brk['flash_ops']:.0f} kernels) | idle share of the "
             f"back-to-back step {1.0 - busy / step_host:.3f}"
             if busy else "not measured (the profiler saw no kernel)"), flush=True)
    print(f"LM checks: kernel vs plain (prefill + {LM['steps']} teacher-forced steps) max "
          f"|dlogit| {rec['kernel_vs_plain_max_err']:.4g} of max |logit| "
          f"{rec['kernel_vs_plain_logit_scale']:.4g} (limit x{LM_LOGIT_TOL}), top-1 same / "
          f"tied within the error / differ {rec['kernel_vs_plain_top1']} | prefill vs forward "
          f"{fwd_err[0]:.4g} | {r} replayed decode steps vs forward max "
          f"{rec['decode_vs_forward_max_err']:.4g} "
          f"| {rec['distinct_generated']} distinct generated tokens | peak "
          f"{rec['peak_gb']:.1f} GB", flush=True)
    return rec, n_pre + n_fwd + sum(per_step)


def new_kernels_phase(torch, np, dev, queries, embeddings):
    """Phase 5, the kernels of the LM and recsys paths at the shapes their
    callers give them: flash attention at stablelm-1.6b's prefill and decode and at
    starcoder2-15b's GQA prefill; pairwise_l2 at the main path's
    brute-force shape (512 queries x every embedding), float32 and
    bfloat16; embedding_bag at MIND's. Each entry point is first called as
    its caller would with the counts at 0 (the launches reported), then
    held against its plain version and timed. -> {name: record}."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops, ref as pw_ref
    from repro_torch.models import recsys

    rng = np.random.default_rng(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    def flash_case(name, b, hq, hkv, t, s, dh, causal, q_offset, kv_len):
        q = randn(b, t, hq, dh).transpose(1, 2)  # the projections' layout
        k, v = randn(b, hkv, s, dh), randn(b, hkv, s, dh)
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        err = held_close(fa_ops.flash_attention(q, k, v, **kw),
                         fa_ref.flash_attention_ref(q, k, v, **kw), **FLASH_TOL,
                         what=f"flash_attention {name}")
        # ms and library_ms back to back, as every kernel line; device_ms and
        # library_device_ms queued behind a sleep (the kernels' own time,
        # which a short call's host time hides back to back); the wrapper's
        # host time a call, the launches enqueued with no sync between
        run = lambda: fa_ops.flash_attention(q, k, v, **kw)
        ms, dev_ms, wrap_ms = time_ms(torch, run, 10), device_ms(torch, run, 10), host_ms(
            torch, run, 50)
        plain_ms = time_ms(torch, lambda: fa_ref.flash_attention_ref(q, k, v, **kw), 3)
        kq, vq = k[:, :, :kv_len], v[:, :, :kv_len]
        lib = dict(is_causal=causal and t == kv_len, enable_gqa=hq != hkv)
        sdpa = lambda: F.scaled_dot_product_attention(q, kq, vq, **lib)
        lib_ms, lib_dev_ms = time_ms(torch, sdpa, 10), device_ms(torch, sdpa, 10)
        # visible (query, key) pairs: this run's work, tiles skipped or not
        if causal:
            pairs = sum(min(kv_len, q_offset + i + 1) for i in range(t))
        else:
            pairs = t * kv_len
        n_flops = 4.0 * b * hq * dh * pairs
        n_bytes = 2 * (2 * q.numel() + 2 * b * hkv * kv_len * dh)  # q, out; k, v valid prefix
        bnd = bound_ms(n_bytes, n_flops, BF16_FLOP_PER_S)
        # the kernel's achieved rate of what bounds it and share of the
        # bound (device only), and its ratio to SDPA both ways
        rate = (f"{n_flops / dev_ms / 1e9:.1f} TFLOP/s" if bnd[1] == "operations"
                else f"{n_bytes / dev_ms / 1e6:.1f} GB/s")
        variant = fa_ops.plan(b, hq, hkv, t, kv_len, q.dtype, sms, causal=causal,
                              q_offset=q_offset, dh=dh).variant
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd[0],
                         bound_by=bnd[1], max_abs_err=err, shape=[b, hq, hkv, t, s, dh],
                         device_ms=dev_ms, library_device_ms=lib_dev_ms, wrapper_host_ms=wrap_ms,
                         bound_share=bnd[0] / dev_ms, vs_sdpa=ms / lib_ms,
                         vs_sdpa_device=dev_ms / lib_dev_ms, variant=variant)
        print(f"  flash_attention {name} B={b} Hq={hq} Hkv={hkv} T={t} S={s} (kv_len {kv_len}) "
              f"dh={dh} bf16 [{variant}]: {ms:.4f} ms (plain {plain_ms:.3f}, SDPA {lib_ms:.4f}, "
              f"bound {bnd[0]:.4f} by {bnd[1]}) err {err:.2e} | device only {dev_ms:.4f} ms "
              f"(SDPA {lib_dev_ms:.4f}): {rate}, {bnd[0] / dev_ms:.1%} of the bound | "
              f"{ms / lib_ms:.2f}x SDPA's time back to back, {dev_ms / lib_dev_ms:.2f}x device "
              f"only | wrapper host {wrap_ms * 1e3:.1f} us a call", flush=True)

    B, P, S = LM["batch"], LM["prompt"], LM["max_len"]
    flash_case("stablelm_prefill", B, 32, 32, P, S, 64, True, 0, P)
    flash_case("stablelm_decode", B, 32, 32, 1, S, 64, False, S - 1, S)
    flash_case("starcoder2_gqa_prefill", 1, 48, 4, P, P, 128, True, 0, P)
    flash_case("starcoder2_gqa_decode", B, 48, 4, 1, S, 128, False, S - 1, S)

    # pairwise_l2: the brute-force distance matrix of the main path's queries
    x, y = queries[:BATCH].contiguous(), embeddings.contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        xd, yd = x.to(dtype), y.to(dtype)
        reset()
        got = pw_ops.pairwise_l2(xd, yd)
        torch.cuda.synchronize()
        n_launch = pw_ops.LAUNCHES["pairwise_l2"]
        check(n_launch == 1, "pairwise_l2 did not launch its kernel")
        err = held_close(got, pw_ref.pairwise_l2_ref(xd, yd), **PW_TOL,
                         what=f"pairwise_l2 {dtype}")
        ms = time_ms(torch, lambda: pw_ops.pairwise_l2(xd, yd), 10)
        plain_ms = time_ms(torch, lambda: pw_ref.pairwise_l2_ref(xd, yd), 2)
        lib_ms = time_ms(torch, lambda: torch.cdist(xd.float(), yd.float()) ** 2, 10)
        n, m, d = xd.shape[0], yd.shape[0], xd.shape[1]
        n_bytes = (n + m) * d * xd.element_size() + n * m * 4
        n_flops = 2.0 * n * m * d + 2.0 * (n + m) * d + 3.0 * n * m
        rate = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        bnd = bound_ms(n_bytes, n_flops, rate)
        tag = str(dtype).replace("torch.", "")
        out[f"pairwise_l2_{tag}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                          bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
                                          launches=n_launch, shape=[n, m, d])
        print(f"  pairwise_l2 {n}x{m}x{d} {tag}: {ms:.4f} ms (plain {plain_ms:.3f}, cdist**2 "
              f"{lib_ms:.4f}, bound {bnd[0]:.4f} by {bnd[1]}) err {err:.2e}, out "
              f"{n * m * 4 / 1e9:.3f} GB", flush=True)
        del got

    # embedding_bag: MIND's history bags, through recsys.bag_lookup
    items = MIND["items"]
    table = recsys.init_tables(SEED, (items,), MIND["dim"], device=dev)
    ids_np = rng.integers(0, items, (MIND["batch"], MIND["hist"])).astype(np.int32)
    ids_np[:, 1] = ids_np[:, 0]  # a repeated item in every history
    ids_np[::7, :10] = ids_np[::7, 10:11]  # and some histories with 11 copies of one
    ids = torch.from_numpy(ids_np).to(dev)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, ids_np.shape).astype(np.float32)).to(dev)
    reset()
    got = recsys.bag_lookup(table, ids, w, use_kernel=True)
    torch.cuda.synchronize()
    n_launch = eb_ops.LAUNCHES["embedding_bag"]
    check(n_launch == 1, "bag_lookup(use_kernel=True) did not launch embedding_bag")
    err = held_close(got, eb_ref.embedding_bag_ref(table, ids, w), **EB_TOL,
                     what="embedding_bag")
    ms = time_ms(torch, lambda: eb_ops.embedding_bag(table, ids, w), 20)
    plain_ms = time_ms(torch, lambda: eb_ref.embedding_bag_ref(table, ids, w), 5)
    lids = ids.long()
    lib_ms = time_ms(torch, lambda: F.embedding_bag(lids, table, per_sample_weights=w,
                                                    mode="sum"), 20)
    n_rows = int(ids.unique().numel())
    n_bytes = n_rows * MIND["dim"] * 4 + ids.numel() * 8 + MIND["batch"] * MIND["dim"] * 4
    bnd = bound_ms(n_bytes, 2.0 * ids.numel() * MIND["dim"])
    out["embedding_bag"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd[0],
                                bound_by=bnd[1], max_abs_err=err, launches=n_launch,
                                distinct_rows=n_rows, shape=[items, MIND["dim"], MIND["batch"],
                                                             MIND["hist"]])
    print(f"  embedding_bag {items}x{MIND['dim']} f32, {MIND['batch']} bags of {MIND['hist']} "
          f"(weighted, {n_rows} distinct rows): {ms:.4f} ms (plain {plain_ms:.3f}, "
          f"F.embedding_bag {lib_ms:.4f}, bound {bnd[0]:.4f} by {bnd[1]}) err {err:.2e}",
          flush=True)
    return out


def main() -> None:
    quick = "--quick" in sys.argv[1:]
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import filtering, kmeans, lmi
    from repro_torch.core import planes as planes_lib
    from repro_torch.core import store as store_lib
    from repro_torch.core.embedding import EmbeddingConfig
    from repro_torch.data.proteins import ProteinGenConfig
    from repro_torch.kernels.beam_eval import ops as be_ops, ref as be_ref
    from repro_torch.kernels.kmeans_assign import ops as ka_ops, ref as ka_ref
    from repro_torch.kernels.lmi_filter import ops as lf_ops, ref as lf_ref
    from repro_torch.launch import build_index as build_cli, serve as serve_cli

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    # ---- 1. build every kernel, in parallel
    build_s = kernels.build_all()
    print(f"card: {smi} | torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"kernel build {build_s:.1f}s", flush=True)
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    if "--lm-only" in sys.argv[1:]:
        # phase 6 alone, to set the LM's serving numbers of two trees side by
        # side in one call: a partial run, so it prints no result line
        lm_phase(torch, np, dev, quick)
        return

    if quick:
        n_obj, arities, gen_chunk = 20_000, (32, 64), 20_000
    else:
        n_obj, arities, gen_chunk = FULL["n_objects"], FULL["arities"], 65536
    ecfg = EmbeddingConfig(n_sections=FULL["n_sections"], cutoff=FULL["cutoff"])

    # ---- 2. the main path: generate, embed, build, query
    reset()
    emb, t_gen, t_emb = build_cli.generate_embeddings(
        SEED, ProteinGenConfig(n_proteins=n_obj, n_families=N_FAMILIES), ecfg, dev,
        chunk_size=gen_chunk)
    torch.cuda.reset_peak_memory_stats()
    ka_ops.SHAPE_LAUNCHES.clear()
    t0 = time.perf_counter()
    index = lmi.build(SEED, emb, arities=arities, model_type="kmeans", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = dict(ka_ops.SHAPE_LAUNCHES)  # kmeans_assign's, by (variant, G, n, k, d)
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    store = store_lib.from_lmi(index, FULL["store_dtype"])
    check(index.n_objects == n_obj, "index lost objects")
    sizes = index.bucket_sizes().cpu().numpy()
    check(int(sizes.sum()) == n_obj and (sizes >= 0).all(), "bucket offsets inconsistent")
    check(np.array_equal(np.sort(index.sorted_ids.cpu().numpy()), np.arange(n_obj)),
          "an object is missing from the buckets or appears twice")

    rng = np.random.default_rng(1)
    qids = rng.integers(0, n_obj, BATCH * (N_BATCHES + 1))
    base = index.sorted_embeddings[torch.from_numpy(qids).to(dev)]
    noise = torch.from_numpy(rng.normal(scale=0.01, size=tuple(base.shape)).astype(np.float32))
    queries = torch.clamp(base + noise.to(dev), 0.0, 1.0)

    def knn(q):
        return filtering.knn_query(index, q, k=FULL["k"], stop_condition=FULL["stop"],
                                   metric=FULL["metric"], store=store)

    ids0, d0 = knn(queries[:BATCH])  # warm-up batch, checked below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(1, N_BATCHES + 1):
        knn(queries[b * BATCH:(b + 1) * BATCH])
    torch.cuda.synchronize()
    t_query = time.perf_counter() - t0
    radius = 0.5
    rq = filtering.range_query(index, queries[:BATCH], radius, stop_condition=FULL["stop"],
                               radius_scale=FULL["radius_scale"], store=store)
    torch.cuda.synchronize()
    launches = read()
    qps = N_BATCHES * BATCH / t_query
    print(f"main path ({n_obj} chains, {'x'.join(map(str, arities))}, {FULL['store_dtype']} "
          f"store): generate {t_gen:.1f}s | embed {t_emb:.2f}s | build {t_build:.2f}s | "
          f"query {t_query:.3f}s for {N_BATCHES}x{BATCH} -> {qps:.0f} QPS | launches {launches}",
          flush=True)
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    check(tuple(ids0.shape) == (BATCH, FULL["k"]) == tuple(d0.shape), "kNN shape")
    found = ids0 >= 0
    check(bool(torch.isfinite(d0[found]).all()), "non-finite kNN distance")
    check(bool(found[:, 0].all()), "a query found no neighbour")

    # the plain path: the same query plan on the card with the plain filter
    # in place of the kernels — the same search, so equal slot for slot
    q = queries[:BATCH]
    stop_count, cap = lmi.query_plan_params(index, FULL["stop"])
    cand_ids, rows, valid, _nb, n_cands, runs = lmi._search_core(index, q, stop_count, cap)
    pd, ps = lf_ref.lmi_filter_topk_ref(q, rows, valid, store.data, FULL["k"],
                                        metric=FULL["metric"])
    pids = torch.where(pd < 1e37, torch.gather(cand_ids, 1, ps.long()), -1)
    agree = filtering.knn_agree(ids0.cpu(), d0.cpu(), pids.cpu(), pd.cpu(), atol=TOL["euclidean"])
    check(bool(agree.all()), f"kNN kernel path != plain path on {int((~agree).sum())} queries")
    prd = lf_ref.lmi_filter_ref(q, rows, valid, store.data, metric=FULL["metric"])
    fin = prd < 1e37
    check(bool(torch.equal(fin, rq.distances < 1e37)), "range: valid slots differ")
    rerr = float((rq.distances[fin] - prd[fin]).abs().max())
    check(rerr <= TOL["euclidean"], f"range distances differ from the plain path by {rerr}")
    cut = FULL["radius_scale"] * radius
    near = (prd - cut).abs() <= TOL["euclidean"]
    check(bool(torch.equal(rq.mask | near, (prd <= cut) | near)), "range masks differ")
    # the same index on the CPU through the entry point: the leaf ranking
    # may break near-ties differently there, so a rare query can visit
    # another bucket at the stop condition
    cpu_index = index.to("cpu")
    cids, cd = filtering.knn_query(cpu_index, q.cpu(), k=FULL["k"], stop_condition=FULL["stop"],
                                   metric=FULL["metric"],
                                   store=store_lib.from_lmi(cpu_index, FULL["store_dtype"]))
    cpu_agree = float(filtering.knn_agree(ids0.cpu(), d0.cpu(), cids, cd,
                                          atol=TOL["euclidean"]).mean())
    check(cpu_agree >= 0.99, f"kNN on the card agrees with the CPU on only {cpu_agree:.3f}")

    bf_ids, _bfd = filtering.brute_force_knn(queries[:BATCH], index.sorted_embeddings,
                                             FULL["k"], metric=FULL["metric"])
    bf = index.sorted_ids[bf_ids.long()].cpu().numpy()
    got = ids0.cpu().numpy()
    recall = float(np.mean([len(np.intersect1d(got[i], bf[i])) / FULL["k"]
                            for i in range(BATCH)]))
    print(f"kNN kernel path == plain path (modulo ties) on {BATCH} queries; "
          f"range max |err| {rerr:.2e}; card vs CPU kNN agreement {cpu_agree:.4f}; "
          f"recall@{FULL['k']} vs brute force {recall:.4f}", flush=True)
    check(recall > 0.5, f"recall@{FULL['k']} {recall} is implausibly low")

    # the same build again from SEED, its stages timed: it must equal the
    # first bit for bit (every level's centroids, offsets, ids)
    index2, build_levels, t_build2, level1_points = build_breakdown(torch, emb, arities, dev)
    empty, sha = fingerprint(index)
    empty2, sha2 = fingerprint(index2)
    same = same_index(torch, index, index2)
    print(f"build fingerprint: empty buckets {empty}, centroids sha256 {sha}, recall@{FULL['k']} "
          f"vs brute force {recall:.4f} | second build from seed {SEED}: empty buckets {empty2}, "
          f"sha256 {sha2}, {'bitwise equal' if same else 'DIFFERENT'} (centroids of every level, "
          f"offsets, ids)", flush=True)
    check(same, "two builds from one seed differ")
    del index2
    # the seeding's CDF over the root's points, summed in a fixed order
    row = torch.softmax(emb[:, 0], 0)
    n_cdf = len({kmeans._cdf(row).cpu().numpy().tobytes() for _ in range(20)})
    print(f"seeding CDF over {row.numel()} points: {n_cdf} distinct result(s) in 20 calls",
          flush=True)
    check(n_cdf == 1, "the seeding's CDF differs from call to call")
    for i, lv in enumerate(build_levels):
        rest = lv["fit"] - sum(lv[st] for st in BUILD_STAGES[:4])
        print(f"build breakdown, level {i} ({lv['groups']} group(s), cap {lv['cap']}, padding "
              f"rows {lv['pad_share']:.1%}, {lv['iterations']} Lloyd steps, kmeans_assign "
              f"wrapper calls {lv['calls']} at {sorted(lv['shapes'])}), ms: fit "
              f"{lv['fit'] * 1e3:.1f}"
              " = " + " + ".join(f"{st} {lv[st] * 1e3:.1f}" for st in BUILD_STAGES[:4])
              + f" + other {rest * 1e3:.1f}; padding {lv['padding'] * 1e3:.1f}; children "
              f"{lv['children'] * 1e3:.1f}", flush=True)
    in_levels = sum(lv["fit"] + lv["padding"] + lv["children"] for lv in build_levels)
    print(f"build: {t_build:.3f} s ({t_build2:.3f} s with the stage timers' synchronisations), "
          f"of it the levels {in_levels:.3f} s and the rest (root routing, CSR store) "
          f"{t_build2 - in_levels:.3f} s | peak memory {build_peak_gb:.2f} GB", flush=True)

    # where a 512-query kNN batch spends its time, stage by stage
    logp = lmi.leaf_log_probs(index, q)
    order, visited, _sz = lmi.rank_visited_buckets(logp, index.bucket_sizes(), stop_count)
    ops_main = lf_ops.desc_operands(q, valid, runs)
    stages = {
        "route": lambda: lmi.leaf_log_probs(index, q),
        "rank+cut": lambda: lmi.rank_visited_buckets(logp, index.bucket_sizes(), stop_count),
        "extract": lambda: lmi.extract_rows(order, visited, index.bucket_offsets, cap),
        "descriptors": lambda: lf_ops.desc_operands(q, valid, runs),
        "filter kernel": lambda: lf_ops.launch(
            ops_main[0], store.data, ops_main[1], k=FULL["k"], metric=FULL["metric"],
            desc=ops_main[2]),
        "knn_query": lambda: knn(q),
    }
    stage_ms = {name: time_ms(torch, fn, 10) for name, fn in stages.items()}
    print("query stages, ms per 512-query batch: "
          + " | ".join(f"{n} {v:.4f}" for n, v in stage_ms.items()), flush=True)

    # the filter's shapes at the main path's search, for the bounds
    covered = int(n_cands.clamp(max=cap).sum())
    touched = torch.zeros(index.n_objects, dtype=torch.bool, device=dev)
    touched[rows[valid].long()] = True
    nrun, dstart, _doff, _dlen = lf_ops._run_descriptors(runs, cap)
    shapes = dict(covered=covered, n_touched=int(touched.sum()), n_runs=int(nrun.sum()), cap=cap,
                  n_valid=int(valid.sum()))

    # ---- 2b. the quantized stores over the same index and queries
    quant_records, quant_launches = quantized_phase(
        torch, np, index, cpu_index, queries, (cand_ids, rows, valid, runs), bf, shapes)

    # ---- 3. the depth-3 beam serving points
    beam_records, d3_launches = depth3_phase(torch, np, index, queries, dev)
    print(f"depth-3 path launches {d3_launches}", flush=True)

    # ---- 4. the CLIs at their defaults, on the card
    if not quick:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "index")
            reset()
            build_cli.main(["--out", out, "--device", "cuda"])
            served = serve_cli.main(["--index", out, "--n-queries", "64", "--device", "cuda"])
            cli_launches = read()
            out3 = os.path.join(tmp, "index_d3")
            reset()
            build_cli.main(["--out", out3, "--device", "cuda", "--arities", "16,16,16",
                            "--beam", "8", "--node-eval", "segmented", "--prebuilt-planes"])
            served3 = serve_cli.main(["--index", out3, "--n-queries", "64", "--device", "cuda"])
            cli3_launches = read()
            outq = os.path.join(tmp, "index_int8")
            reset()
            build_cli.main(["--out", outq, "--device", "cuda", "--store-dtype", "int8",
                            "--scale-granularity", "bucket", "--compute-dtype", "int8"])
            banner = io.StringIO()
            with contextlib.redirect_stdout(banner):
                servedq = serve_cli.main(["--index", outq, "--n-queries", "64", "--device",
                                          "cuda"])
            print(banner.getvalue(), end="")
            cliq_launches = read()
        print(f"CLI phase launches {cli_launches}; depth-3 beam CLI launches {cli3_launches}; "
              f"int8 CLI launches {cliq_launches}", flush=True)
        check(served.shape == (64, 30) and (served[:, 0] >= 0).all(), "serve answers")
        check(cli_launches["kmeans_assign"] > 0 and cli_launches["lmi_filter_topk_desc"] > 0,
              "the CLIs did not run the kernels")
        check(served3.shape == (64, 30) and (served3[:, 0] >= 0).all(), "depth-3 serve answers")
        for name in D3_KERNELS:
            check(cli3_launches[name] > 0, f"the depth-3 beam CLIs did not launch {name}")
        check(servedq.shape == (64, 30) and (servedq[:, 0] >= 0).all(), "int8 serve answers")
        check("store dtype int8 (bucket scales, int8 compute)" in banner.getvalue(),
              "the int8 serve banner does not name its tier")
        check(cliq_launches.get("lmi_filter_topk_desc:int8:run:int8", 0) > 0,
              "the int8 CLIs did not launch the int8 variant")

    # ---- 5. kernels vs plain versions at the main path's shapes, every
    # store tier in both gather forms
    d = index.dim
    print(f"filter shapes: Q={BATCH} cap={cap} K={dstart.shape[1]} covered slots={covered} "
          f"distinct rows={shapes['n_touched']} live runs={shapes['n_runs']} "
          f"valid slots={shapes['n_valid']}", flush=True)
    records = {}
    for tier in STORE_TIERS:
        dtype, gran, compute = tier
        st = store_lib.from_lmi(index, dtype, scale_granularity=gran)
        item = st.data.element_size()
        qf, v, dkw, rkw = launch_operands(torch, lf_ops, store_lib, st, compute, q, rows, valid,
                                          runs)
        for metric in ("euclidean", "sq_euclidean", "cosine"):
            tol = INT_TOL if compute == "int8" else TOL[metric]
            plain = plain_filter(lf_ref, store_lib, q, rows, valid, st, compute, metric)
            pd, ps = plain_topk(torch, plain, FULL["k"])
            fin_r, fin_k = plain < 1e37, pd < 1e37
            rec = {}
            for form, kw in (("desc", dkw), ("rows", rkw)):
                kd, ks = lf_ops.launch(qf, st.data, v, k=FULL["k"], metric=metric, **kw)
                kr = lf_ops.launch(qf, st.data, v, metric=metric, **kw)
                check(bool(torch.equal(fin_k, kd < 1e37)),
                      f"topk {form} {tier_name(tier)}/{metric}: exhausted slots")
                terr, trel = errors(kd[fin_k], pd[fin_k])
                check(terr <= tol, f"topk {form} {tier_name(tier)}/{metric}: |err| {terr} > {tol}")
                check(bool(torch.equal(kr < 1e37, fin_r)),
                      f"range {form} {tier_name(tier)}/{metric}: valid slots")
                rerr, rrel = errors(kr[fin_r], plain[fin_r])
                check(rerr <= tol, f"range {form} {tier_name(tier)}/{metric}: |err| {rerr} > {tol}")
                t_topk = time_ms(torch, lambda kw=kw: lf_ops.launch(
                    qf, st.data, v, k=FULL["k"], metric=metric, **kw), 20)
                t_range = time_ms(torch, lambda kw=kw: lf_ops.launch(
                    qf, st.data, v, metric=metric, **kw), 20)
                ops, rate = filter_ops(tier, shapes, d)
                b_topk = bound_ms(filter_bytes(tier, item, d, BATCH, shapes, form, FULL["k"]),
                                  ops, rate)
                b_range = bound_ms(filter_bytes(tier, item, d, BATCH, shapes, form, 0), ops, rate)
                rec[form] = dict(topk=[t_topk, None, b_topk, terr, trel],
                                 range=[t_range, None, b_range, rerr, rrel])
            t_topk_ref = time_ms(torch, lambda: plain_topk(torch, plain_filter(
                lf_ref, store_lib, q, rows, valid, st, compute, metric), FULL["k"]), 5)
            t_range_ref = time_ms(torch, lambda: plain_filter(
                lf_ref, store_lib, q, rows, valid, st, compute, metric), 5)
            for form in rec:
                rec[form]["topk"][1], rec[form]["range"][1] = t_topk_ref, t_range_ref
            records[(tier_name(tier), metric)] = rec
            print(f"  {tier_name(tier):30s} {metric:12s} "
                  + " | ".join(f"{form}: topk {r['topk'][0]:.4f} (bound {r['topk'][2][0]:.4f}, "
                               f"err {r['topk'][3]:.1e}) range {r['range'][0]:.4f} (bound "
                               f"{r['range'][2][0]:.4f}, err {r['range'][3]:.1e})"
                               for form, r in rec.items())
                  + f" | plain topk {t_topk_ref:.3f} range {t_range_ref:.3f} | gathered "
                  f"{covered * d * item / 1e6:.1f} MB", flush=True)

    # the assignment at the build's two shapes: every point against the root
    # centroids, and level 1's padded groups against their children
    assign_records = assign_phase(torch, dev, ka_ops, ka_ref, (
        ("root", emb[None], index.levels[0]["centroids"][None]),
        ("level1", level1_points, index.levels[1]["centroids"])), build_levels, build_launches)

    # ---- 5 (continued). flash attention, pairwise_l2 and embedding_bag at
    # their callers' shapes
    new_records = new_kernels_phase(torch, np, dev, queries, index.sorted_embeddings)

    # ---- 6. serve stablelm-1.6b: prefill, greedy decode, forward
    lm_rec, lm_launches = lm_phase(torch, np, dev, quick)

    def entry(name, replaces, rec, n_launch, **extra):
        ms, plain, (bms, by), err, rel = rec
        return {"name": name, "route": "cuda", "source": lf_src, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None, **extra}

    def tiers(kind, form, metric=FULL["metric"]):
        """Every tier's (ms, plain, bound) of one kernel and gather form."""
        return {tier_name(t): dict(zip(("ms", "plain_ms", "bound_ms"), (
            records[(tier_name(t), metric)][form][kind][0],
            records[(tier_name(t), metric)][form][kind][1],
            records[(tier_name(t), metric)][form][kind][2][0]))) for t in STORE_TIERS}

    def rec(tier, form, kind):
        return records[(tier_name(tier), FULL["metric"])][form][kind]

    def tier_launches(pred) -> int:
        """Launches of the quantized phase whose tier key satisfies pred."""
        return sum(n for key, n in quant_launches.items() if ":" in key and pred(key.split(":")))

    kf = "src/repro/kernels/lmi_filter/kernel.py"
    main_tier = (FULL["store_dtype"], "row", "float32")
    int_tier = ("int8", "bucket", "int8")
    lf_src = "src/repro_torch/kernels/lmi_filter/csrc/lmi_filter.cu"
    out = {"kernels": [
        entry("lmi_filter_topk_desc", f"{kf}:691", rec(main_tier, "desc", "topk"),
              launches["lmi_filter_topk_desc"], store=tier_name(main_tier),
              tiers=tiers("topk", "desc")),
        entry("lmi_filter_range_desc", f"{kf}:650", rec(main_tier, "desc", "range"),
              launches["lmi_filter_range_desc"], store=tier_name(main_tier),
              tiers=tiers("range", "desc")),
        entry("lmi_filter_topk_rows", f"{kf}:604", rec(int_tier, "rows", "topk"),
              quant_launches.get("lmi_filter_topk_rows", 0), store=tier_name(int_tier),
              tiers=tiers("topk", "rows")),
        entry("lmi_filter_range_rows", f"{kf}:565", rec(int_tier, "rows", "range"),
              quant_launches.get("lmi_filter_range_rows", 0), store=tier_name(int_tier),
              tiers=tiers("range", "rows")),
        # the quantized tiers inside the four: each timed as the top-k
        # descriptor kernel of the store that exercises it; launches are the
        # quantized phase's launches of any kernel running that tier
        entry("lmi_filter_dequant", f"{kf}:230",
              rec(("int8", "row", "float32"), "desc", "topk"),
              tier_launches(lambda t: t[1] in ("int8", "float8_e4m3fn") and t[3] == "float32"),
              store="int8/row/float32"),
        entry("lmi_filter_run_scale", f"{kf}:212",
              rec(("float8_e4m3fn", "bucket", "float32"), "desc", "topk"),
              tier_launches(lambda t: t[2] == "run"), store="float8_e4m3fn/bucket/float32"),
        entry("lmi_filter_int8", f"{kf}:274", rec(int_tier, "desc", "topk"),
              tier_launches(lambda t: t[3] == "int8"), store=tier_name(int_tier)),
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/kernels/kmeans_assign/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign/kernel.py:42",
         "launches": launches["kmeans_assign"], **assign_records["root"],
         "level1": assign_records["level1"]},
    ], "quantized_stores": quant_records}
    kb = beam_records["kmeans"]  # the family of the path; all three under "families"
    out["kernels"].append({
        "name": "beam_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/beam_eval/csrc/beam_eval.cu",
        "replaces": "src/repro/kernels/beam_eval/kernel.py:122",
        "launches": d3_launches["beam_eval"], "max_abs_err": kb["max_abs_err"],
        "ms": kb["ms"], "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
        "bound_by": kb["bound_by"], "library_ms": None, "families": beam_records})
    fp, pre = "src/repro/kernels", "src/repro_torch/kernels"
    fa = new_records["stablelm_prefill"]
    out["kernels"].append({
        "name": "flash_attention", "route": "cuda",
        "source": f"{pre}/flash_attention/csrc/flash_attention.cu",
        "replaces": f"{fp}/flash_attention/kernel.py:75", "launches": lm_launches,
        **{key: fa[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms", "library_device_ms")},
        "per_layer_at": "stablelm-1.6b prefill", "decode": new_records["stablelm_decode"],
        "gqa": new_records["starcoder2_gqa_prefill"],
        "gqa_decode": new_records["starcoder2_gqa_decode"], "lm": lm_rec})
    pw = new_records["pairwise_l2_float32"]
    out["kernels"].append({
        "name": "pairwise_l2", "route": "cuda", "source": f"{pre}/pairwise_l2/csrc/pairwise_l2.cu",
        "replaces": f"{fp}/pairwise_l2/kernel.py:44",
        **{key: pw[key] for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        "bfloat16": new_records["pairwise_l2_bfloat16"]})
    eb = new_records["embedding_bag"]
    out["kernels"].append({
        "name": "embedding_bag", "route": "cuda",
        "source": f"{pre}/embedding_bag/csrc/embedding_bag.cu",
        "replaces": f"{fp}/embedding_bag/kernel.py:60",
        **{key: eb[key] for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "distinct_rows")}})
    print(f"card: {smi}")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
