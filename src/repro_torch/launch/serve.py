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
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import filtering
from repro_torch.core import store as store_lib
from repro_torch.index_io import load_index, load_meta, serving_defaults


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
                    help="candidate-store precision, float32 or bfloat16 (default: the "
                         "build's meta.json store_dtype, else float32)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to serve on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    index = load_index(args.index, device=device)
    defaults = serving_defaults(load_meta(args.index))
    store_dtype = store_lib.validate_dtype(args.store_dtype or defaults["store_dtype"],
                                           flag="--store-dtype")
    store = store_lib.from_lmi(index, store_dtype)
    print(f"index: {index.n_objects} objects, {index.n_leaves} buckets "
          f"(depth {index.depth}, arities {'x'.join(map(str, index.arities))}), "
          f"dim {index.dim}, store dtype {store_dtype}, beam exact, on {device}")
    print(f"candidate store: {store.nbytes() / 2**20:.1f} MB")

    # queries: perturbed database objects (realistic near-duplicate load)
    rng = np.random.default_rng(args.seed)
    ids = rng.integers(0, index.n_objects, args.n_queries)
    queries = index.sorted_embeddings.cpu().numpy()[ids]
    queries = np.clip(queries + rng.normal(scale=0.01, size=queries.shape).astype(np.float32), 0, 1)

    def fn(q):
        return filtering.knn_query(index, q, k=args.k, stop_condition=args.stop,
                                   metric=args.metric, max_radius=args.radius, store=store)

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
