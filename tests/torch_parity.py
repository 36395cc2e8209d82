"""Shared helpers of the tests that hold the PyTorch port against the JAX
package on the same inputs (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, the port with ``device="cpu"`` (the plain versions of
its kernels).
"""
from __future__ import annotations

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import lmi as jlmi
from repro.launch import serve as jserve
from repro_torch.core import lmi as plmi
from repro_torch.index_io import index_from_numpy

# the JAX suite's own tolerances (tests/test_lmi_filter.py): norm
# decomposition vs direct difference, per metric; end-to-end Euclidean
# on real embeddings meets self-distances (sqrt of the cancellation)
TOL = {"euclidean": 1e-4, "sq_euclidean": 1e-5, "cosine": 1e-5}
E2E_ATOL = 2e-3
LOGP_ATOL = 1e-5

FAMILIES = ("kmeans", "gmm", "kmeans+logreg")


def np_(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def to_port(index) -> "object":
    """The port's LMI (on the CPU) holding a JAX LMI's arrays."""
    return index_from_numpy(
        [{k: np.asarray(v) for k, v in lv.items()} for lv in index.levels],
        np.asarray(index.bucket_offsets), np.asarray(index.sorted_ids),
        np.asarray(index.sorted_embeddings), arities=index.arities,
        model_type=index.model_type, max_bucket_size=index.max_bucket_size, device="cpu")


def random_params(rng, family: str, lead: tuple, arity: int, d: int) -> dict:
    if family == "kmeans":
        return {"centroids": rng.uniform(0, 1, (*lead, arity, d)).astype(np.float32)}
    if family == "gmm":
        lw = rng.normal(size=(*lead, arity))
        lw = lw - np.log(np.exp(lw).sum(-1, keepdims=True))
        return {"means": rng.uniform(0, 1, (*lead, arity, d)).astype(np.float32),
                "variances": rng.uniform(0.2, 1.0, (*lead, arity, d)).astype(np.float32),
                "log_weights": lw.astype(np.float32)}
    return {"w": rng.normal(size=(*lead, d, arity)).astype(np.float32),
            "b": rng.normal(size=(*lead, arity)).astype(np.float32)}


def random_jax_index(seed: int, family: str, arities, n: int = 600, d: int = 12):
    """A JAX LMI with random node parameters (no fit) and points routed
    to their argmax leaf — cheap, and enough to exercise routing."""
    rng = np.random.default_rng(seed)
    levels = [random_params(rng, family, () if i == 0 else (math.prod(arities[:i]),), a, d)
              for i, a in enumerate(arities)]
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    stub = jlmi.LMI(arities=tuple(arities), model_type=family,
                    levels=tuple({k: jnp.asarray(v) for k, v in lv.items()} for lv in levels),
                    bucket_offsets=jnp.zeros((math.prod(arities) + 1,), jnp.int32),
                    sorted_ids=jnp.zeros((n,), jnp.int32), sorted_embeddings=jnp.asarray(x))
    leaf = np.asarray(jnp.argmax(jax.jit(jlmi.leaf_log_probs)(stub, x), axis=-1))
    perm = np.argsort(leaf, kind="stable")
    sizes = np.bincount(leaf, minlength=math.prod(arities))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return jlmi.LMI(arities=tuple(arities), model_type=family, levels=stub.levels,
                    bucket_offsets=jnp.asarray(offsets), sorted_ids=jnp.asarray(perm, jnp.int32),
                    sorted_embeddings=jnp.asarray(x[perm]), max_bucket_size=int(sizes.max()))


def perturbed_queries(emb, n: int, seed: int = 1, scale: float = 0.01) -> np.ndarray:
    """Queries near database objects, the serve launcher's load."""
    rng = np.random.default_rng(seed)
    e = np.asarray(emb)
    q = e[rng.integers(0, e.shape[0], n)]
    return np.clip(q + rng.normal(scale=scale, size=q.shape), 0, 1).astype(np.float32)


def runs_case(seed=0, n_q=6, n_buckets=20, d=16, stop=30, cap=48):
    """Queries, a CSR store and JAX search outputs whose runs match rows /
    valid, from a random leaf ranking: -> (q, emb, offsets, rows, valid,
    runs). Ragged candidate counts, an empty bucket inside the visited
    stream, and queries with fewer than 40 candidates (exhausted top-40
    slots); each run is one bucket, as the search emits them."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 9, n_buckets).astype(np.int32)
    sizes[4] = 0
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    emb = rng.normal(size=(int(offsets[-1]), d)).astype(np.float32)
    logp = rng.normal(size=(n_q, n_buckets)).astype(np.float32)
    order, visited, sz = jlmi.rank_visited_buckets(jnp.asarray(logp), jnp.asarray(sizes), stop)
    rows, valid, _n = jlmi.extract_rows(order, visited, jnp.asarray(offsets), cap)
    runs = jlmi.BucketRuns(starts=jnp.asarray(offsets)[order].astype(jnp.int32),
                           lengths=jnp.where(visited, sz, 0).astype(jnp.int32))
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    return q, emb, offsets, np.asarray(rows), np.asarray(valid), runs


def port_runs(runs):
    """JAX `BucketRuns` as the port's."""
    return plmi.BucketRuns(starts=torch.tensor(np.asarray(runs.starts)),
                           lengths=torch.tensor(np.asarray(runs.lengths)))


def jax_serve_answers(monkeypatch, argv):
    """Run JAX's serve CLI and return its answers (ids, distances) in
    request order."""
    captured = []

    class Capturing(jserve.ServingHarness):
        def run_until_drained(self):
            responses = super().run_until_drained()
            captured.extend(responses)
            return responses

    monkeypatch.setattr(jserve, "ServingHarness", Capturing)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    captured.sort(key=lambda r: r.rid)
    return np.stack([r.ids for r in captured]), np.stack([r.distances for r in captured])
