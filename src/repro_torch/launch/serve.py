"""Serving launcher of the port: batched protein similarity queries
against a built LMI index (counterpart of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --index /tmp/lmi_index --n-queries 64 \
      --k 30 --stop 0.01 [--device cuda]

Loads an index (written by either package), materializes the candidate
store at the requested precision, and answers kNN queries through the
synchronous fixed-shape batch loop — the JAX launcher's
``--serving serial``: every batch runs at the ``--batch`` shape, partial
batches padded with repeats of row 0 and their padding outputs dropped.
A warmup batch runs first, so the reported QPS and per-query p50 / p99
(each query's share of its batch's service time) are steady-state.
The continuous-batching harness is a later slice (ROADMAP queue A).

The store precision, scale granularity, compute dtype, beam,
temperatures and node evaluation default to the build's meta.json keys
as in the JAX launcher (a ``beam_widths`` schedule over the scalar
``beam_width``; missing keys mean a float32 store, row scales, float32
compute, exact enumeration, temperature 1.0, per-pair gather); the flags
of the same names override them. The banner names the compute dtype the
filter resolved (int8 compute needs an int8 store). Indexes built with
``--prebuilt-planes`` serve the segmented beam from the saved planes,
refolded at startup when the serving temperatures differ from theirs.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import filtering, lmi
from repro_torch.core import planes as planes_lib
from repro_torch.core import store as store_lib
from repro_torch.index_io import load_index, load_meta, load_planes, serving_defaults
from repro_torch.launch.build_index import parse_beam, parse_temperatures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", type=str, required=True)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--stop", type=float, default=0.01)
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--metric", choices=("euclidean", "cosine"), default="euclidean")
    ap.add_argument("--store-dtype", type=str, default=None,
                    help="candidate-store precision, one of "
                         f"{', '.join(store_lib.STORE_DTYPES)} (default: the build's "
                         "meta.json store_dtype, else float32)")
    ap.add_argument("--scale-granularity", choices=store_lib.SCALE_GRANULARITIES,
                    default=None,
                    help="quantization scale granularity: 'row' or 'bucket' (default: "
                         "the build's meta.json scale_granularity, else row)")
    ap.add_argument("--compute-dtype", choices=("float32", "int8"), default=None,
                    help="filter contraction domain: 'int8' runs the integer-domain "
                         "path for int8 stores (other stores run float32; default: the "
                         "build's meta.json compute_dtype, else float32)")
    ap.add_argument("--beam", type=str, default=None,
                    help="beam for the leaf ranking: a scalar width or a comma schedule "
                         "'64,16' (one width per pruned level; default: the build's "
                         "meta.json beam_widths / beam_width; 0 forces exact)")
    ap.add_argument("--temperatures", type=str, default=None,
                    help="comma per-level temperatures '1.0,0.7,0.5' (default: the "
                         "build's meta.json temperatures, else 1.0 everywhere)")
    ap.add_argument("--node-eval", choices=lmi.NODE_EVAL_MODES, default=None,
                    help="how the beam's pruned levels read node models: 'gather' or "
                         "'segmented' (the beam_eval kernel on CUDA; default: the "
                         "build's meta.json node_eval)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for parity with the JAX launcher and has no effect: "
                         "on CUDA the port's kernels always run, on the CPU their plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to serve on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    index = load_index(args.index, device=device)
    defaults = serving_defaults(load_meta(args.index))
    store_dtype = store_lib.validate_dtype(args.store_dtype or defaults["store_dtype"],
                                           flag="--store-dtype")
    scale_granularity = store_lib.validate_granularity(
        args.scale_granularity or defaults["scale_granularity"])
    compute_dtype = args.compute_dtype or defaults["compute_dtype"]
    beam = defaults["beam"] if args.beam is None else parse_beam(args.beam)
    temperatures = (defaults["temperatures"] if args.temperatures is None
                    else parse_temperatures(args.temperatures))
    node_eval = args.node_eval or defaults["node_eval"]
    planes = load_planes(args.index, index)
    if planes is not None:
        temps = lmi.normalize_temperatures(temperatures, index.depth)
        if planes.temperatures != temps:
            print(f"prebuilt planes folded with temperatures {planes.temperatures} != "
                  f"serving {temps}; refolding")
            planes = planes_lib.from_lmi(index, temperatures)
    store = store_lib.from_lmi(index, store_dtype, scale_granularity=scale_granularity)
    compute = filtering._effective_compute(store, compute_dtype)
    compute_str = (f"{compute} compute" if compute == compute_dtype
                   else f"{compute} compute; {compute_dtype} asked for, which needs an int8 "
                        "store")
    beam_str = ("exact" if beam is None
                else ",".join(map(str, beam)) if isinstance(beam, tuple) else beam)
    temp_str = "1.0" if temperatures is None else ",".join(f"{t:g}" for t in temperatures)
    print(f"index: {index.n_objects} objects, {index.n_leaves} buckets "
          f"(depth {index.depth}, arities {'x'.join(map(str, index.arities))}), "
          f"dim {index.dim}, store dtype {store_dtype} ({scale_granularity} scales, "
          f"{compute_str}), beam {beam_str}, "
          f"temperatures {temp_str}, node eval {node_eval}"
          + (f", prebuilt planes {planes.nbytes() / 2**20:.1f} MB" if planes is not None
             else "") + f", on {device}")
    print(f"candidate store: {store.nbytes() / 2**20:.1f} MB")

    # queries: perturbed database objects (realistic near-duplicate load)
    rng = np.random.default_rng(args.seed)
    ids = rng.integers(0, index.n_objects, args.n_queries)
    queries = index.sorted_embeddings.cpu().numpy()[ids]
    queries = np.clip(queries + rng.normal(scale=0.01, size=queries.shape).astype(np.float32), 0, 1)

    def fn(q):
        return filtering.knn_query(index, q, k=args.k, stop_condition=args.stop,
                                   metric=args.metric, max_radius=args.radius, store=store,
                                   beam_width=beam, node_eval=node_eval,
                                   temperatures=temperatures, planes=planes,
                                   compute_dtype=compute)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    bs = args.batch
    t0 = time.perf_counter()
    fn(torch.from_numpy(np.broadcast_to(queries[:1], (bs, queries.shape[1])).copy()).to(device))
    sync()
    t_warm = time.perf_counter() - t0

    answers, lat = [], []
    t0 = time.perf_counter()
    for s in range(0, len(queries), bs):
        block = queries[s:s + bs]
        n = block.shape[0]
        if n < bs:  # pad with repeats of row 0 (one fixed shape)
            block = np.concatenate([block, np.broadcast_to(block[:1], (bs - n, block.shape[1]))])
        tb = time.perf_counter()
        ids_b, _d = fn(torch.from_numpy(np.ascontiguousarray(block)).to(device))
        ids_b = ids_b.cpu().numpy()  # synchronises
        dt = time.perf_counter() - tb
        answers.append(ids_b[:n])
        lat += [dt / bs * 1e3] * n
    wall = time.perf_counter() - t0
    n_batches = -(-len(queries) // bs)
    print(f"answered {len(queries)} queries (k={args.k}, stop={args.stop}, serving=serial)")
    print(f"throughput: {len(queries) / wall:.1f} QPS over {n_batches} batches")
    print(f"latency/query: median={np.median(lat):.2f}ms p99={np.percentile(lat, 99):.2f}ms "
          f"(warmup batch: {t_warm * 1e3:.0f}ms, excluded)")
    print("sample answer ids[0]:", answers[0][0][:10])
    return np.concatenate(answers)


if __name__ == "__main__":
    main()
