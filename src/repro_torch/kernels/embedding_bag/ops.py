"""Wrapper of the embedding-bag kernel (``csrc/embedding_bag.cu``).

Counterpart of ``repro.kernels.embedding_bag.ops.embedding_bag``. CUDA
tensors launch the hand-written row-gather kernel (or raise); CPU tensors
take the plain version in `ref.py`. There is no fallback from one to the
other. ``mode="mean"`` stays here, outside the kernel, as in JAX.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.embedding_bag.ref import bag_mean, embedding_bag_ref

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it)
LAUNCHES = {"embedding_bag": 0}

MAX_BAG = 1024  # ids and weights of one bag sit in the kernel's shared memory
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = kernels.load("embedding_bag").embedding_bag
    if fn.argtypes is None:  # declared once, at first use
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
    return fn


def launch(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """The kernel's weighted sum-bag: -> (B, D) float32."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table (V, D) and ids (B, L) expected, got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"embedding_bag kernel takes a float32 or bfloat16 table, "
                        f"got {table.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"embedding_bag takes integer ids, got {ids.dtype}")
    B, L = ids.shape
    if L > MAX_BAG:
        raise ValueError(f"embedding_bag kernel takes bags of at most {MAX_BAG}, got {L}")
    if weights is not None and tuple(weights.shape) != (B, L):
        raise ValueError(f"weights {tuple(weights.shape)} do not match ids {(B, L)}")
    dev = table.device
    if ids.device != dev or (weights is not None and weights.device != dev):
        raise ValueError("table, ids and weights must be on the same device")
    table = table.contiguous()
    ids = ids.to(torch.int32).contiguous()
    w = None if weights is None else weights.to(torch.float32).contiguous()
    out = torch.empty((B, table.shape[1]), dtype=torch.float32, device=dev)
    if B == 0 or table.shape[1] == 0:
        return out
    with torch.cuda.device(dev):
        status = _lib()(kernels.ptr(table), kernels.ptr(ids),
                        None if w is None else kernels.ptr(w), _DTYPE_CODE[table.dtype],
                        table.shape[0], table.shape[1], B, L, kernels.ptr(out),
                        kernels.stream_handle())
    kernels.check_status("embedding_bag", status)
    LAUNCHES["embedding_bag"] += 1
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: table (V, D), ids (B, L) int, optional weights (B, L)
    -> (B, D) float32, summed (or averaged) over the bag."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on CUDA or CPU tensors, got {table.device}")
    out = launch(table, ids, weights)
    return bag_mean(out, ids, weights) if mode == "mean" else out
