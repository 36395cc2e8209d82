"""Wrapper of the fused K-Means assignment kernel (``csrc/kmeans_assign.cu``).

Dispatch is by the device of the tensors: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the plain version in
`ref.py`. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it)
LAUNCHES = {"kmeans_assign": 0}

_MAX_DIM = 1024  # widest point row the kernel's register tile takes


def _lib():
    lib = kernels.load("kmeans_assign")
    fn = lib.kmeans_assign_f32
    if fn.argtypes is None:  # declared once, at first use
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
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
    with torch.cuda.device(x.device):
        status = _lib()(kernels.ptr(x), kernels.ptr(c), g, n, k, d, kernels.ptr(labels),
                        kernels.ptr(mind), kernels.stream_handle())
    kernels.check_status("kmeans_assign", status)
    LAUNCHES["kmeans_assign"] += 1
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
