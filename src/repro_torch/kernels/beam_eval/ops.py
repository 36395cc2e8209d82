"""Host side of the segmented beam node evaluation (counterpart of
``repro.kernels.beam_eval.ops``): canonical planes, dispatch by device,
and the byte accounting of one pruned-level evaluation.

`lmi.beam_leaf_ranking` evaluates, per pruned level, one node model for
every live (query, beam-prefix) pair. A per-pair gather reads that pair's
whole (arity, d) parameter block; sorted by node id, the pairs sharing a
node form one run, and the kernel of ``csrc/beam_eval.cu`` loads each
run's block once. CUDA tensors launch that kernel (or raise); CPU tensors
take the plain version in `ref.py`. There is no fallback from one to the
other.

`segment_stats` replays the kernel's tiles and runs in numpy on a
measured frontier and reports the bytes both access patterns move;
chip_smoke.py takes the kernel's bound from it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.beam_eval import ref

_LOG2PI = math.log(2.0 * math.pi)

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it)
LAUNCHES = {"beam_eval": 0}

_FAMILY_CODE = {"kmeans": 0, "gmm": 1, "kmeans+logreg": 2}

_FAMILY_SHAPES = {
    # (n_mats, n_vecs, raw param floats per node block: what the gather
    # mode reads per pair, every parameter tensor of the level)
    "kmeans": (1, 1, lambda a, d: a * d),
    "gmm": (2, 3, lambda a, d: 2 * a * d + a),
    "kmeans+logreg": (1, 1, lambda a, d: a * d + a),
}

# node-sorted pairs per block and warps per block (two pairs each per
# wave): of the tiles of 16-128 pairs and 4-16 warps timed on an H100 at
# the depth-3 serving shape, the smallest tile ran fastest, because more
# blocks in flight hide the latency of the per-run plane loads
TILE_PAIRS = 16
WARPS = 4
MAX_ARITY = 1024
MAX_DIM = 512
_SMEM_MAX = 232_448  # shared memory a block may opt in to on Hopper


class Planes(NamedTuple):
    """Canonical per-level node-model parameters (formulas in `ref`).

    ``mats[m]``: (N, arity, d) f32; m=0 is contracted with the query,
    m=1 (gmm only) with the squared query. ``vecs``: (N, arity) f32."""

    mats: tuple
    vecs: tuple


def _f32(x: float) -> torch.Tensor:
    """A float32 scalar, so a scaling is one float32 multiply as in JAX's
    ``x * jnp.float32(s)``."""
    return torch.tensor(x, dtype=torch.float32)


def family_planes(model_type: str, params: dict, temperature: float = 1.0) -> Planes:
    """Canonicalize one stacked level's params (leading N node dim) into
    contraction planes.

    ``temperature`` folds into the planes: kmeans centroids scale by
    ``T**-0.5`` (`node_scores` scales the query the same way, and the
    scaling commutes with the clamp), gmm / logreg planes by ``1/T``
    (their scores are linear in the planes). ``temperature == 1.0``
    skips the scaling, so the planes are bit for bit the unscaled ones."""
    if model_type == "kmeans":
        c = params["centroids"].float()
        if temperature != 1.0:
            c = c * _f32(temperature ** -0.5)
        return Planes(mats=(c,), vecs=(torch.sum(c * c, dim=-1),))
    if model_type == "gmm":
        means = params["means"].float()
        variances = params["variances"].float()
        inv = 1.0 / variances
        d = means.shape[-1]
        logdet = torch.sum(torch.log(variances), dim=-1)
        planes = Planes(
            mats=(means * inv, inv),
            vecs=(params["log_weights"].float(), torch.sum(means * means * inv, dim=-1),
                  d * _LOG2PI + logdet),
        )
    elif model_type == "kmeans+logreg":
        planes = Planes(mats=(params["w"].float().transpose(-1, -2).contiguous(),),
                        vecs=(params["b"].float(),))
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    if temperature != 1.0:
        inv_t = _f32(1.0 / temperature)
        planes = Planes(mats=tuple(m * inv_t for m in planes.mats),
                        vecs=tuple(v * inv_t for v in planes.vecs))
    return planes


def _plan(n_mats: int, arity: int, d: int) -> tuple[int, int, int]:
    """(ds, ca, smem bytes) of a launch: the odd shared-memory row stride,
    the children per shared-memory chunk (``ca >= arity``: the node's
    whole block is resident, loaded once per run), and the block's dynamic
    shared memory. Mirrors ``beam_eval_smem_bytes`` in the source."""
    ds = d | 1
    fixed = 4 * (2 * WARPS * (d + arity) + TILE_PAIRS)
    ca = min(arity, (_SMEM_MAX - fixed) // (4 * n_mats * ds))
    return ds, ca, fixed + 4 * n_mats * ca * ds


def _lib():
    lib = kernels.load("beam_eval")
    fn = lib.beam_eval_f32
    if fn.argtypes is None:  # declared once, at first use
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [p, i, p, p, i, i, i, p, p, p, p, p, i, i, i, i, i, i, p, p]
    return fn


def sort_pairs(prefix: torch.Tensor):
    """The (query, prefix) pairs sorted by node id, on the device: ->
    (node_s (P,) int32, order (P,) int32), ``order[j]`` the original pair
    index of sorted position j (a stable sort: equal nodes keep pair
    order)."""
    node_s, order = torch.sort(prefix.reshape(-1).to(torch.int32), stable=True)
    return node_s, order.to(torch.int32)


def _check(q: torch.Tensor, prefix: torch.Tensor, planes: Planes, model_type: str):
    """Raise on what the kernel does not take."""
    if model_type not in _FAMILY_CODE:
        raise ValueError(f"unknown model_type {model_type!r}")
    n_mats, n_vecs, _raw = _FAMILY_SHAPES[model_type]
    if len(planes.mats) != n_mats or len(planes.vecs) != n_vecs:
        raise ValueError(f"{model_type} planes take {n_mats} matrices and {n_vecs} vectors, "
                         f"got {len(planes.mats)} and {len(planes.vecs)}")
    nq, d = q.shape
    n_nodes, arity = planes.mats[0].shape[:2]
    if arity > MAX_ARITY or d > MAX_DIM:
        raise ValueError(f"the beam_eval kernel takes arity <= {MAX_ARITY} and d <= {MAX_DIM}, "
                         f"got arity {arity}, d {d}")
    if prefix.dim() != 2 or prefix.shape[0] != nq:
        raise ValueError(f"prefix {tuple(prefix.shape)} does not match queries {tuple(q.shape)}")
    if prefix.numel() >= 2 ** 31:
        raise ValueError("the beam_eval kernel takes fewer than 2**31 pairs")
    for name, t, shape in ([("mats", m, (n_nodes, arity, d)) for m in planes.mats]
                           + [("vecs", v, (n_nodes, arity)) for v in planes.vecs]):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, the queries on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if prefix.device != q.device:
        raise ValueError(f"prefix is on {prefix.device}, the queries on {q.device}")


def launch_sorted(q: torch.Tensor, node_s: torch.Tensor, order: torch.Tensor, f: int,
                  planes: Planes, model_type: str) -> torch.Tensor:
    """Launch the kernel on node-sorted pairs (`sort_pairs`) of queries
    ``q`` (Q, d) float32 contiguous with ``f`` prefixes each -> (Q * f,
    arity) child log-probs in the original pair order. The caller has
    checked the operands (`node_scores` does)."""
    n_mats, n_vecs, _raw = _FAMILY_SHAPES[model_type]
    n_nodes, arity, d = planes.mats[0].shape
    p = node_s.numel()
    mats = [m.contiguous() for m in planes.mats]
    vecs = [v.contiguous() for v in planes.vecs]
    out = torch.empty((p, arity), dtype=torch.float32, device=q.device)
    if p == 0:
        return out
    ds, ca, _smem = _plan(n_mats, arity, d)
    ptrs = [kernels.ptr(t) for t in mats] + [None] * (2 - n_mats)
    ptrs += [kernels.ptr(t) for t in vecs] + [None] * (3 - n_vecs)
    with torch.cuda.device(q.device):
        status = _lib()(kernels.ptr(q), d, kernels.ptr(node_s), kernels.ptr(order), p, f,
                        n_nodes, *ptrs, _FAMILY_CODE[model_type], arity, ds, ca, WARPS,
                        TILE_PAIRS, kernels.ptr(out), kernels.stream_handle())
    kernels.check_status("beam_eval", status)
    LAUNCHES["beam_eval"] += 1
    return out


def node_scores(queries: torch.Tensor, prefix: torch.Tensor, planes: Planes, model_type: str,
                use_kernel: bool = False, interpret=None, temperature: float = 1.0):
    """(Q, F, arity) child log-probs of each query's beam frontier.

    ``temperature`` must be the one the ``planes`` were folded with: for
    kmeans the query takes the other ``T**-0.5`` here, in float32.
    Dispatch is by device: CUDA tensors launch the kernel, CPU tensors run
    the plain version. ``use_kernel`` / ``interpret`` are kept for the JAX
    signature and change nothing."""
    del use_kernel, interpret
    q = queries.float()
    if model_type == "kmeans" and temperature != 1.0:
        q = q * _f32(temperature ** -0.5)
    if q.device.type == "cpu":
        return ref.node_scores_ref(q, prefix, planes, model_type)
    if q.device.type != "cuda":
        raise ValueError(f"beam_eval runs on CUDA or CPU tensors, got {q.device}")
    _check(q, prefix, planes, model_type)
    node_s, order = sort_pairs(prefix)
    out = launch_sorted(q.contiguous(), node_s, order, prefix.shape[1], planes, model_type)
    return out.view(prefix.shape[0], prefix.shape[1], -1)


# ------------------------------------------------------ traffic accounting


def segment_stats(prefix, model_type: str, arity: int, dim: int, n_nodes: int,
                  prebuilt_planes: bool = False) -> dict:
    """Node-parameter bytes of one pruned-level evaluation of the frontier
    ``prefix`` (Q, F), replaying the CUDA kernel's tiles and runs:

      * ``gather_bytes``: the gather mode, every pair reads its node's raw
        parameter block;
      * ``segmented_mat_bytes``: one canonical-matrix block per run start
        in a tile (per wave of warps, two pairs each, when the block is
        not resident);
      * ``vec_bytes``: the per-pair (arity,) vector-plane reads;
      * ``planes_bytes``: the once-per-batch read of the raw params that
        builds the planes (0 with prebuilt planes);
      * ``n_touched_nodes``: distinct nodes, what a kernel must read at
        least once.

    ``segmented_bytes`` totals the segmented side."""
    n_mats, n_vecs, raw_floats = _FAMILY_SHAPES[model_type]
    _ds, ca, _smem = _plan(n_mats, arity, dim)
    node = np.sort(np.asarray(prefix, np.int64).reshape(-1))
    p0 = node.size
    pos = np.arange(p0)
    start = (pos % TILE_PAIRS == 0) | np.concatenate([[True], node[1:] != node[:-1]])
    seg_len = np.diff(np.append(np.flatnonzero(start), p0))  # run pieces per tile
    n_loads = int(seg_len.size if ca >= arity else np.sum(-(-seg_len // (2 * WARPS))))
    block = raw_floats(arity, dim) * 4
    mat_block = n_mats * arity * dim * 4
    stats = {
        "n_pairs": int(p0),
        "n_nodes": int(n_nodes),
        "n_touched_nodes": int(np.unique(node).size),
        "n_param_loads": n_loads,
        "tile_pairs": TILE_PAIRS,
        "gather_bytes": p0 * block,
        "segmented_mat_bytes": n_loads * mat_block,
        "vec_bytes": p0 * n_vecs * arity * 4,
        "planes_bytes": 0 if prebuilt_planes else n_nodes * block,
    }
    stats["segmented_bytes"] = (stats["segmented_mat_bytes"] + stats["vec_bytes"]
                                + stats["planes_bytes"])
    return stats
