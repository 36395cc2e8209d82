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
 3. CLI: ``build_index`` -> ``serve`` at the CLI defaults (20k chains,
    (32, 64)), 64 queries, on the card;
 4. kernels vs their plain PyTorch versions on the card, at the shapes
    the main path gave them (512 queries, the full build's candidate
    capacity, float32 and bfloat16 stores, 3 metrics; 518,576 x 256 x 45
    for the assignment), with CUDA-event times and the bound of each.

The line before the last is the ``{"kernels": [...]}`` JSON; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or run
from a directory without the repository's ``src/repro_torch``, it exits
non-zero and prints no result.
"""
from __future__ import annotations

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

# H100 SXM peaks (NVIDIA data sheet): HBM rate, non-tensor-core float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# |kernel - plain| limits, by metric: the kernels use the norm
# decomposition, the plain version the direct difference; Euclidean near
# self-distance takes the sqrt of the decomposition's cancellation
# (the JAX suite's end-to-end bound), the others its kernel TOL.
TOL = {"euclidean": 2e-3, "sq_euclidean": 1e-4, "cosine": 1e-5}
ASSIGN_TOL = 1e-4  # min squared distance, and the margin of a label swap


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


def bound_ms(n_bytes: float, n_flops: float):
    """(least ms, what bounds it): bytes over HBM rate vs float32 operations
    over the non-tensor-core float32 rate."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def errors(got, want):
    """(max abs, max rel) difference; rel against |want|, floored at 1e-6
    so distances near 0 (a query next to its own row) stay finite."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp(min=1e-6)).max())


def reset(ka_ops, lf_ops) -> None:
    for counts in (ka_ops.LAUNCHES, lf_ops.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read(ka_ops, lf_ops) -> dict:
    return {**ka_ops.LAUNCHES, **lf_ops.LAUNCHES}


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
    from repro_torch.core import store as store_lib
    from repro_torch.core.embedding import EmbeddingConfig
    from repro_torch.data.proteins import ProteinGenConfig
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
    reset(ka_ops, lf_ops)
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
    launches = read(ka_ops, lf_ops)
    qps = N_BATCHES * BATCH / t_query
    print(f"main path ({n_obj} chains, {'x'.join(map(str, arities))}, {FULL['store_dtype']} "
          f"store): generate {t_gen:.1f}s | embed {t_emb:.2f}s | build {t_build:.2f}s | "
          f"query {t_query:.3f}s for {N_BATCHES}x{BATCH} -> {qps:.0f} QPS | launches {launches}",
          flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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
        "filter kernel": lambda: lf_ops.lmi_filter_topk_desc(
            ops_main[0], store.data, *ops_main[1:], FULL["k"], metric=FULL["metric"]),
        "knn_query": lambda: knn(q),
    }
    stage_ms = {name: time_ms(torch, fn, 10) for name, fn in stages.items()}
    print("query stages, ms per 512-query batch: "
          + " | ".join(f"{n} {v:.4f}" for n, v in stage_ms.items()), flush=True)

    # ---- 3. the CLIs at their defaults, on the card
    if not quick:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "index")
            reset(ka_ops, lf_ops)
            build_cli.main(["--out", out, "--device", "cuda"])
            served = serve_cli.main(["--index", out, "--n-queries", "64", "--device", "cuda"])
            cli_launches = read(ka_ops, lf_ops)
        print(f"CLI phase launches {cli_launches}", flush=True)
        check(served.shape == (64, 30) and (served[:, 0] >= 0).all(), "serve answers")
        check(cli_launches["kmeans_assign"] > 0 and cli_launches["lmi_filter_topk_desc"] > 0,
              "the CLIs did not run the kernels")

    # ---- 4. kernels vs plain versions at the main path's shapes
    covered = int(n_cands.clamp(max=cap).sum())
    touched = torch.zeros(index.n_objects, dtype=torch.bool, device=dev)
    touched[rows[valid].long()] = True
    n_touched = int(touched.sum())
    nrun, dstart, _doff, _dlen = lf_ops._run_descriptors(runs, cap)
    # what the kernels must read besides the rows: the queries, each
    # query's run count and its nrun live descriptors, the valid flag of
    # each covered slot (entries past nrun / past the cover are never read)
    meta_bytes = q.numel() * 4 + nrun.numel() * 4 + 12 * int(nrun.sum()) + covered
    d = index.dim
    print(f"filter shapes: Q={BATCH} cap={cap} K={dstart.shape[1]} covered slots={covered} "
          f"distinct rows={n_touched}", flush=True)
    records = {}
    for sdt in ("float32", "bfloat16"):
        st = store_lib.from_lmi(index, sdt)
        item = st.data.element_size()
        for metric in ("euclidean", "sq_euclidean", "cosine"):
            kd, ks = lf_ops.lmi_filter_topk(q, rows, valid, st.data, FULL["k"], metric=metric,
                                            runs=runs)
            rd, rs = lf_ref.lmi_filter_topk_ref(q, rows, valid, st.data, FULL["k"], metric=metric)
            fin = rd < 1e37
            check(bool(torch.equal(fin, kd < 1e37)), f"topk {sdt}/{metric}: exhausted slots")
            terr, trel = errors(kd[fin], rd[fin])
            check(terr <= TOL[metric], f"topk {sdt}/{metric}: |err| {terr} > {TOL[metric]}")
            kr = lf_ops.lmi_filter_range(q, rows, valid, st.data, metric=metric, runs=runs)
            rr = lf_ref.lmi_filter_ref(q, rows, valid, st.data, metric=metric)
            check(bool(torch.equal(kr < 1e37, rr < 1e37)), f"range {sdt}/{metric}: valid slots")
            fr = rr < 1e37
            rerr, rrel = errors(kr[fr], rr[fr])
            check(rerr <= TOL[metric], f"range {sdt}/{metric}: |err| {rerr} > {TOL[metric]}")
            reps = 20
            ops_in = lf_ops.desc_operands(q, valid, runs)
            t_topk = time_ms(torch, lambda: lf_ops.lmi_filter_topk_desc(
                ops_in[0], st.data, *ops_in[1:], FULL["k"], metric=metric), reps)
            t_topk_host = time_ms(torch, lambda: lf_ops.lmi_filter_topk(
                q, rows, valid, st.data, FULL["k"], metric=metric, runs=runs), reps)
            t_topk_ref = time_ms(torch, lambda: lf_ref.lmi_filter_topk_ref(
                q, rows, valid, st.data, FULL["k"], metric=metric), 5)
            t_range = time_ms(torch, lambda: lf_ops.lmi_filter_range_desc(
                ops_in[0], st.data, *ops_in[1:], metric=metric), reps)
            t_range_ref = time_ms(torch, lambda: lf_ref.lmi_filter_ref(
                q, rows, valid, st.data, metric=metric), 5)
            flops = covered * d * 4  # q.c and |c|^2: two FMAs per gathered element
            in_bytes = n_touched * d * item + meta_bytes
            b_topk = bound_ms(in_bytes + BATCH * FULL["k"] * 8, flops)
            b_range = bound_ms(in_bytes + BATCH * cap * 4, flops)
            print(f"  {sdt:8s} {metric:12s} topk {t_topk:.4f} ms (+descriptors {t_topk_host:.4f}, "
                  f"plain {t_topk_ref:.3f}, "
                  f"bound {b_topk[0]:.4f}) err {terr:.1e} rel {trel:.1e} | range {t_range:.4f} ms "
                  f"(plain {t_range_ref:.3f}, bound {b_range[0]:.4f}) err {rerr:.1e} "
                  f"rel {rrel:.1e} | "
                  f"gathered {covered * d * item / 1e6:.1f} MB", flush=True)
            records[(sdt, metric)] = dict(topk=(t_topk, t_topk_ref, b_topk, terr, trel),
                                          range=(t_range, t_range_ref, b_range, rerr, rrel))

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

    main_rec = records[(FULL["store_dtype"], FULL["metric"])]

    def entry(name, cu, replaces, rec, n_launch):
        ms, plain, (bms, by), err, rel = rec
        return {"name": name, "route": "cuda", "source": cu, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "library_ms": None}

    lf_src = "src/repro_torch/kernels/lmi_filter/csrc/lmi_filter.cu"
    out = {"kernels": [
        entry("lmi_filter_topk_desc", lf_src, "src/repro/kernels/lmi_filter/kernel.py:691",
              main_rec["topk"], launches["lmi_filter_topk_desc"]),
        entry("lmi_filter_range_desc", lf_src, "src/repro/kernels/lmi_filter/kernel.py:650",
              main_rec["range"], launches["lmi_filter_range_desc"]),
        entry("kmeans_assign", "src/repro_torch/kernels/kmeans_assign/csrc/kmeans_assign.cu",
              "src/repro/kernels/kmeans_assign/kernel.py:42",
              (t_assign, t_assign_ref, b_assign, aerr, arel), launches["kmeans_assign"]),
    ]}
    print(f"card: {smi}")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
