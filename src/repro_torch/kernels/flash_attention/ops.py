"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
the plain version in `ref.py`. There is no fallback from one to the
other.

The kernel takes what JAX's wrapper refuses: any T and S (the ragged
edge is masked in the kernel, no 128-alignment), a query offset other
than ``S - T`` and a valid kv prefix shorter than S. That is what
prefill into a longer cache (``q_offset=0, kv_len=T``) and a decode step
(``causal=False, kv_len=pos + 1``) need. q, k and v may be strided
views, as the transformer's (B, T, H, dh) projections seen as
(B, H, T, dh) are; only the last dim must be contiguous.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it)
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for; smaller ones are zero-padded
SHORT_BLOCK = 16  # query blocks of at most this many rows (decode) split their kv range
KV_TILE = 64  # kv positions per kernel tile
BLOCKS_PER_SM = 8  # split target: this many short-block kernel blocks per SM
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = kernels.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:  # declared once, at first use
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _last_dim_dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, q_offset: int,
           kv_len: int) -> torch.Tensor:
    """The kernel on CUDA tensors: -> (B, Hq, T, dh) in q's dtype, laid
    out like q. The scale is ``dh**-0.5`` of the true dh."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Hq, T, dh) and k, v (B, Hkv, S, dh) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} / {Hkv}")
    if dh > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes head dims up to {HEAD_DIMS[-1]}, got {dh}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on the same device")
    if not 0 <= kv_len <= S or q_offset < 0:
        raise ValueError(f"need 0 <= kv_len <= S and q_offset >= 0, got kv_len {kv_len}, "
                         f"S {S}, q_offset {q_offset}")
    width = next(w for w in HEAD_DIMS if w >= dh)
    if width != dh:  # zero columns leave q.k and p.v unchanged (JAX's wrapper pads too)
        q, k, v = (F.pad(t, (0, width - dh)) for t in (q, k, v))
    q, k, v = _last_dim_dense(q), _last_dim_dense(k), _last_dim_dense(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :dh]
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    splits, part = 1, None
    if T <= SHORT_BLOCK:  # B * Hq blocks only: split the kv range (the kernel may use fewer)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = max(1, min(-(-BLOCKS_PER_SM * sms // (B * Hq)), -(-max(kv_len, 1) // KV_TILE)))
        if splits > 1:
            part = torch.empty((splits, B * Hq, T, width + 2), dtype=torch.float32,
                               device=q.device)
    with torch.cuda.device(q.device):
        status = _lib()(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out),
                        _DTYPE_CODE[q.dtype], B, Hq, Hkv, T, S, width, strides, int(causal),
                        q_offset, kv_len, dh ** -0.5, splits,
                        None if part is None else kernels.ptr(part), kernels.stream_handle())
    kernels.check_status("flash_attention", status)
    LAUNCHES["flash_attention"] += 1
    return out if width == dh else out[..., :dh]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    q_offset: int | None = None, kv_len: int | None = None) -> torch.Tensor:
    """GQA attention, blockwise online softmax: q (B, Hq, T, dh); k, v
    (B, Hkv, S, dh) -> (B, Hq, T, dh) in q's dtype, scaled by the true
    ``dh**-0.5``. ``q_offset`` defaults to ``S - T`` (queries at the end
    of the kv stream, the TPU kernel's function) and ``kv_len`` to S."""
    S, T = k.shape[2], q.shape[2]
    q_offset = S - T if q_offset is None else int(q_offset)
    kv_len = S if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    return launch(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
