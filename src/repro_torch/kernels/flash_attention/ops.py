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
(B, H, T, dh) are; only the last dim must be contiguous. The bf16
kernels stage whole rows with 16-byte copies, so a bf16 operand whose
base or row strides are not 16-byte aligned is first copied contiguous.

The launch (kernel variant, grid, kv splits, merge scratch) is the pure
function `plan`, which needs no card. The source takes the variant and
the split from it, derives the grid from the same tile sizes, and
refuses splits that leave a kv tile uncovered or a split empty.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# launches of the CUDA kernel by this wrapper, for run-time proof that a
# path went through it (chip_smoke.py resets and reads it)
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for; smaller ones are zero-padded
SHORT_BLOCK = 16  # at most this many query rows (decode) take the split-kv kernels
KV_TILE = 64  # kv positions per kernel tile
# Query rows a block, as the source's kernels take them. The source derives
# its grid from its own constants; these set only the split count (blocks
# before splitting) and Plan.grid, so a drift costs occupancy, not safety.
F32_ROWS = (16, 64)  # the float32 kernel: T <= SHORT_BLOCK, longer
PREFILL_ROWS = {64: 128, 128: 192}  # the bf16 prefill kernel (kPrefillRows), by dh
DECODE_ROWS = 16  # of a kv head's T x Hq / Hkv rows, the bf16 decode kernel (kDecodeRows)
# split target: this many short-block blocks an SM (the f32 kernel's 64-thread
# blocks, the bf16 decode kernel's 128-thread ones)
BLOCKS_PER_SM = {"f32": 8, "bf16_decode": 2}
VARIANTS = ("f32", "bf16_prefill", "bf16_decode")  # index = the source's variant code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Plan:
    """One launch: the kernel variant, its grid (x, y, z = splits), the kv
    tiles of a split, and the float32 scratch the merge reads (None
    without a split)."""
    variant: str
    grid: tuple[int, int, int]
    tiles_per_split: int
    scratch: tuple[int, int, int, int] | None

    @property
    def splits(self) -> int:
        return self.grid[2]


@functools.lru_cache(maxsize=1024)
def plan(B: int, Hq: int, Hkv: int, T: int, kv_len: int, dtype: torch.dtype, sms: int, *,
         causal: bool = False, q_offset: int = 0, dh: int = HEAD_DIMS[0]) -> Plan:
    """The kernel's launch for these shapes on a card of ``sms`` SMs.

    float32 takes the CUDA-core kernel, one block per (batch * q head,
    q tile). bfloat16 takes the tensor-core prefill kernel when T >
    SHORT_BLOCK, one block per (batch * q head, PREFILL_ROWS[dh] query
    rows), and the decode kernel otherwise, one block per (batch * kv
    head, 16 of the group's T x Hq / Hkv rows). Short blocks split the kv
    tiles their rows see over ``splits`` blocks, up to BLOCKS_PER_SM
    blocks an SM: no split is empty, and the scratch is (splits, B * Hq,
    T, dh + 2), what the merge kernel reads. ``dh`` is the padded head
    dim."""
    kv_end = min(kv_len, q_offset + T) if causal else kv_len
    n_tiles = -(-max(kv_end, 0) // KV_TILE)
    if dtype == torch.float32:
        variant = "f32"
        grid_xy = (B * Hq, -(-T // F32_ROWS[T > SHORT_BLOCK]))
    elif dtype == torch.bfloat16:
        variant = "bf16_prefill" if T > SHORT_BLOCK else "bf16_decode"
        grid_xy = ((B * Hq, -(-T // PREFILL_ROWS[dh])) if T > SHORT_BLOCK
                   else (B * Hkv, -(-(T * (Hq // Hkv)) // DECODE_ROWS)))
    else:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {dtype}")
    splits = 1
    if T <= SHORT_BLOCK and n_tiles > 1:  # too few blocks to fill the card: split the kv range
        base = grid_xy[0] * grid_xy[1]
        splits = min(-(-BLOCKS_PER_SM[variant] * sms // base), n_tiles)
    tiles = max(1, -(-n_tiles // splits))
    splits = max(1, -(-n_tiles // tiles))
    return Plan(variant=variant, grid=(*grid_xy, splits), tiles_per_split=tiles,
                scratch=(splits, B * Hq, T, dh + 2) if splits > 1 else None)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib():
    fn = kernels.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:  # declared once, at first use
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _last_dim_dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself when its base and its (batch, head, position) strides
    allow the bf16 kernels' 16-byte copies of whole rows, else a
    contiguous copy (a fresh, aligned allocation)."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(st % step == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
                                      if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


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
    p = plan(B, Hq, Hkv, T, kv_len, q.dtype, _sm_count(q.device), causal=causal,
             q_offset=q_offset, dh=width)
    if p.variant != "f32":
        q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    part = (None if p.scratch is None
            else torch.empty(p.scratch, dtype=torch.float32, device=q.device))
    with torch.cuda.device(q.device):
        status = _lib()(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out),
                        _DTYPE_CODE[q.dtype], B, Hq, Hkv, T, S, width, strides, int(causal),
                        q_offset, kv_len, dh ** -0.5, VARIANTS.index(p.variant), p.splits,
                        p.tiles_per_split, None if part is None else kernels.ptr(part),
                        kernels.stream_handle())
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
