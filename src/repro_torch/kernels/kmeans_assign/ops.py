"""Wrapper of the fused K-Means assignment kernel (``csrc/kmeans_assign.cu``).

Dispatch is by the device of the tensors: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the plain version in
`ref.py`. There is no fallback from one to the other, nor from one
variant of the kernel to the other.

The launch (variant, padded widths, chunk, grid, shared memory) is the
pure function `plan`, which needs no card. The source takes the variant,
chunk, padded width and block count from it, and derives the rest (the
tiles, each block's range of them, the shared-memory bytes) itself.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch import kernels
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it), in all, by
# variant, and by (variant, G, n, k, d)
LAUNCHES = {"kmeans_assign": 0}
VARIANT_LAUNCHES = {"kmeans_assign:tensor_core": 0, "kmeans_assign:cuda_core": 0}
SHAPE_LAUNCHES: dict[tuple, int] = {}

VARIANTS = ("cuda_core", "tensor_core")  # index = the source's variant code
_MAX_DIM = 1024  # widest point row the CUDA-core kernel's register tile takes
TC_MAX_DIM = 64  # widest row of the tensor-core variant
TC_WIDTHS = (48, 64)  # its padded row widths (the source's d_pad cases)
TC_CHUNKS = (256, 64)  # centroids a wgmma (N), widest first
TC_ROWS = 128  # point rows of one (group, tile) pair: two warpgroups of 64
SMEM_LIMIT = 232_448  # a block's opt-in shared memory on the H100
CC_THREADS = 256  # points a block of the CUDA-core variant (one a thread)
CC_SMEM_FLOATS = 12_288  # its static shared memory: a centroid chunk and norms


@dataclass(frozen=True)
class Plan:
    """One launch: the variant; k padded to the centroid rows the kernel
    holds (a multiple of 8: whole chunks for the tensor cores), the padded
    row width, centroids a chunk (the wgmma width, or the CUDA-core
    variant's shared-memory chunk), point rows a tile, the (groups, tiles a
    group) the tiles make, the grid, and a block's shared-memory bytes."""
    variant: str
    k_pad: int
    d_pad: int
    chunk: int
    tile: int
    tiles: tuple[int, int]
    grid: tuple[int, int]
    smem_bytes: int


def tc_smem_bytes(k_pad: int, d_pad: int) -> int:
    """The tensor-core variant's dynamic shared memory (the source's
    ``tc_smem_bytes``): centroid hi / lo and norms, two stages of hi / lo
    128-row point tiles, 1 KB of alignment."""
    return 1024 + 8 * k_pad * d_pad + 4 * k_pad + 2 * 2 * TC_ROWS * d_pad * 4


@functools.lru_cache(maxsize=1024)
def plan(G: int, n: int, k: int, d: int, sms: int) -> Plan:
    """The kernel's launch for x (G, n, d), centroids (G, k, d) on a card
    of ``sms`` SMs.

    d <= 64 takes the tensor-core variant: rows padded to 48 or 64
    columns; chunks of 256 centroids (the root's k), or of 64 (level 1's
    k) when k <= 128 or whole chunks of 256 do not fit shared memory
    beside the point tiles; one persistent block an SM (a block holds
    most of the SM's shared memory) walking contiguous ranges of the
    G x ceil(n / 128) (group, tile) pairs. Wider rows, or a k whose
    centroids fit in no chunk width, take the CUDA-core variant: one
    thread a point, grid (ceil(n / 256), G)."""
    if G < 1 or n < 1 or k < 1 or d < 1:
        raise ValueError(f"kmeans_assign plan needs positive shapes, got G={G} n={n} k={k} d={d}")
    if d > _MAX_DIM:
        raise ValueError(f"kmeans_assign kernel takes d <= {_MAX_DIM}, got {d}")
    if d <= TC_MAX_DIM:
        d_pad = next(w for w in TC_WIDTHS if w >= d)
        tiles = (G, -(-n // TC_ROWS))
        for chunk in TC_CHUNKS:
            if chunk > TC_CHUNKS[-1] and chunk // 2 >= k:  # a narrower chunk covers k
                continue
            k_pad = -(-k // chunk) * chunk
            smem = tc_smem_bytes(k_pad, d_pad)
            if smem <= SMEM_LIMIT:
                return Plan("tensor_core", k_pad, d_pad, chunk, TC_ROWS, tiles,
                            (min(tiles[0] * tiles[1], sms), 1), smem)
    if G > 65535:
        raise ValueError(f"kmeans_assign CUDA-core variant takes at most 65535 groups, got {G}")
    tiles = (G, -(-n // CC_THREADS))
    return Plan("cuda_core", -(-k // 8) * 8, d, min(k, CC_SMEM_FLOATS // (d + 1)), CC_THREADS,
                tiles, (tiles[1], G), CC_SMEM_FLOATS * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib():
    lib = kernels.load("kmeans_assign")
    fn = lib.kmeans_assign_f32
    if fn.argtypes is None:  # declared once, at first use
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch(x: torch.Tensor, c: torch.Tensor):
    """x (G, n, d), c (G, k, d) float32 contiguous on one CUDA device."""
    g, n, d = x.shape
    k = c.shape[1]
    if c.shape[0] != g or c.shape[2] != d:
        raise ValueError(f"centroids {tuple(c.shape)} do not match points {tuple(x.shape)}")
    if k < 1:
        raise ValueError("kmeans_assign needs at least one centroid")
    if d > _MAX_DIM:
        raise ValueError(f"kmeans_assign kernel takes d <= {_MAX_DIM}, got {d}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("kmeans_assign kernel takes float32 points and centroids")
    if c.device != x.device:
        raise ValueError("points and centroids must be on the same device")
    x = x.contiguous()
    c = c.contiguous()
    labels = torch.empty((g, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((g, n), dtype=torch.float32, device=x.device)
    if n == 0 or g == 0:
        return labels, mind
    p = plan(g, n, k, d, _sm_count(x.device))
    with torch.cuda.device(x.device):
        status = _lib()(kernels.ptr(x), kernels.ptr(c), g, n, k, d, VARIANTS.index(p.variant),
                        p.chunk, p.d_pad, p.grid[0], kernels.ptr(labels), kernels.ptr(mind),
                        kernels.stream_handle())
    kernels.check_status("kmeans_assign", status)
    LAUNCHES["kmeans_assign"] += 1
    VARIANT_LAUNCHES[f"kmeans_assign:{p.variant}"] += 1
    key = (p.variant, g, n, k, d)
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return labels, mind


def kmeans_assign_with_dist(x: torch.Tensor, centroids: torch.Tensor):
    """Fused assignment: -> (labels (..., n) int32, min_d2 (..., n) f32).

    x (n, d) with centroids (k, d), or a batch of groups x (G, n, d)
    with centroids (G, k, d) — one launch covers every group."""
    if x.device.type == "cpu":
        return kmeans_assign_ref(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on CUDA or CPU tensors, got {x.device}")
    if x.dim() == 2:
        labels, mind = _launch(x[None], centroids[None])
        return labels[0], mind[0]
    return _launch(x, centroids)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Labels only (drop-in for `repro_torch.core.kmeans.assign`)."""
    return kmeans_assign_with_dist(x, centroids)[0]
