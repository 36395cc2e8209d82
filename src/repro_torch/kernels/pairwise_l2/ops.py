"""Wrapper of the all-pairs squared-L2 kernel (``csrc/pairwise_l2.cu``).

Counterpart of ``repro.kernels.pairwise_l2.ops.pairwise_l2``. CUDA
tensors launch the hand-written kernel (or raise); CPU tensors take the
plain version in `ref.py`. There is no fallback from one to the other.
The kernel masks ragged n, m and d itself, so nothing is padded.

Nothing in the port's pipeline calls it, because nothing in JAX's does:
``repro.core.distances``'s docstring says ``repro.core.filtering`` uses
the Pallas kernel, but that use was replaced (JAX ``distances.py:64``,
``filtering.py:364``). The filter (`kernels.lmi_filter`) and the K-Means
assignment (`kernels.kmeans_assign`) fuse their distances into kernels
of their own; `repro_torch.core.distances.pairwise_sq_euclidean` is the
plain matrix-product form used elsewhere.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.pairwise_l2.ref import pairwise_l2_ref

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it)
LAUNCHES = {"pairwise_l2": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = kernels.load("pairwise_l2").pairwise_l2
    if fn.argtypes is None:  # declared once, at first use
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x (n, d) and y (m, d) expected, got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise TypeError(f"pairwise_l2 kernel takes float32 or bfloat16 x and y of one type, "
                        f"got {x.dtype}, {y.dtype}")
    if y.device != x.device:
        raise ValueError("x and y must be on the same device")
    x, y = x.contiguous(), y.contiguous()
    n, d = x.shape
    out = torch.empty((n, y.shape[0]), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        status = _lib()(kernels.ptr(x), kernels.ptr(y), _DTYPE_CODE[x.dtype], n, y.shape[0], d,
                        kernels.ptr(out), kernels.stream_handle())
    kernels.check_status("pairwise_l2", status)
    LAUNCHES["pairwise_l2"] += 1
    return out


def pairwise_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distance matrix (n, m) float32 between x (n, d) and
    y (m, d): ``max(|x|^2 + |y|^2 - 2 x.y, 0)`` on the card."""
    if x.device.type == "cpu":
        return pairwise_l2_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_l2 runs on CUDA or CPU tensors, got {x.device}")
    return launch(x, y)
