#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # everything, on one CUDA card
    python3 chip_smoke.py --quick    # build + check the kernels at small shapes only

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
    recall@30 vs brute force is printed;
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
    forms, 3 metrics; 518,576 x 256 x 45 for the assignment; 32,768
    (query, prefix) pairs over 4,096 nodes of arity 64 for beam_eval, 3
    families), with CUDA-event times and the bound of each.

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
# rate, dense int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12

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
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.kernels.lmi_filter import ops as lf_ops

    return (ka_ops.LAUNCHES, lf_ops.LAUNCHES, lf_ops.TIER_LAUNCHES, be_ops.LAUNCHES)


def reset() -> None:
    for counts in counters():
        for name in counts:
            counts[name] = 0


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
          f"empty {(sizes == 0).sum()}; planes "
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
    from repro_torch.core import filtering, lmi
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
    t0 = time.perf_counter()
    index = lmi.build(SEED, emb, arities=arities, model_type="kmeans", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
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

    x = emb  # the root fit's shapes: every point against the 256 root centroids
    c = index.levels[0]["centroids"]
    kl, km = ka_ops.kmeans_assign_with_dist(x, c)
    rl, rm = ka_ref.kmeans_assign_ref(x, c)
    aerr, arel = errors(km, rm)
    check(aerr <= ASSIGN_TOL, f"kmeans_assign min d2 |err| {aerr}")
    swapped = kl != rl
    if bool(swapped.any()):  # a label swap is fine only between near-equal centroids
        xs = x[swapped]
        gap = ((xs - c[kl[swapped].long()]) ** 2).sum(-1) - ((xs - c[rl[swapped].long()]) ** 2).sum(-1)
        check(float(gap.abs().max()) <= ASSIGN_TOL, "kmeans_assign labels differ beyond ties")
    t_assign = time_ms(torch, lambda: ka_ops.kmeans_assign_with_dist(x, c), 20)
    t_assign_ref = time_ms(torch, lambda: ka_ref.kmeans_assign_ref(x, c), 5)
    n, kk = x.shape[0], c.shape[0]
    b_assign = bound_ms(n * d * 4 + kk * d * 4 + n * 8, 2.0 * n * kk * d)
    print(f"  kmeans_assign {n}x{kk}x{d}: {t_assign:.4f} ms (plain {t_assign_ref:.3f}, "
          f"bound {b_assign[0]:.4f}) err {aerr:.1e} rel {arel:.1e}, "
          f"label swaps {int(swapped.sum())}",
          flush=True)

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
         "launches": launches["kmeans_assign"], "max_abs_err": aerr, "max_rel_err": arel,
         "ms": t_assign, "plain_ms": t_assign_ref, "bound_ms": b_assign[0],
         "bound_by": b_assign[1], "library_ms": None},
    ], "quantized_stores": quant_records}
    kb = beam_records["kmeans"]  # the family of the path; all three under "families"
    out["kernels"].append({
        "name": "beam_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/beam_eval/csrc/beam_eval.cu",
        "replaces": "src/repro/kernels/beam_eval/kernel.py:122",
        "launches": d3_launches["beam_eval"], "max_abs_err": kb["max_abs_err"],
        "ms": kb["ms"], "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
        "bound_by": kb["bound_by"], "library_ms": None, "families": beam_records})
    print(f"card: {smi}")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
