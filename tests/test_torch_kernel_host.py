"""The host side of the port's kernel wrappers, on the CPU: the ctypes
declarations each wrapper makes before its first launch, and the flash
kernel's launch plan (``flash_attention.ops.plan``) and operand
alignment. Nothing here launches a kernel or needs a card."""
import ctypes
import itertools

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.beam_eval import ops as be_ops
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.kmeans_assign import ops as ka_ops
from repro_torch.kernels.lmi_filter import ops as lf_ops
from repro_torch.kernels.pairwise_l2 import ops as pw_ops


# ------------------------------------------------------ ctypes declarations
class _StubFn:
    """A C function as a fresh ``ctypes.CDLL`` hands it out: restype is
    ctypes' default ``c_int`` and no argtypes are declared."""

    def __init__(self):
        self.restype = ctypes.c_int
        self.argtypes = None


class _StubLib:
    def __getattr__(self, name):
        fn = _StubFn()
        setattr(self, name, fn)
        return fn


# (wrapper module, its library's C function)
WRAPPERS = [
    (ka_ops, "kmeans_assign_f32"),
    (be_ops, "beam_eval_f32"),
    (lf_ops, "lmi_filter"),
    (fa_ops, "flash_attention_fwd"),
    (pw_ops, "pairwise_l2"),
    (eb_ops, "embedding_bag"),
]


@pytest.mark.parametrize("mod,fn_name", WRAPPERS, ids=[w[1] for w in WRAPPERS])
def test_lib_declares_argtypes(monkeypatch, mod, fn_name):
    """Every wrapper declares its function's restype and argtypes on the
    library ``kernels.load`` returns, although restype already is c_int;
    without argtypes a float or 64-bit argument would pass as a C int."""
    lib = _StubLib()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    mod._lib()
    fn = getattr(lib, fn_name)
    assert fn.restype is ctypes.c_int
    assert fn.argtypes is not None and len(fn.argtypes) > 0
    assert all(t is not None for t in fn.argtypes)


# ------------------------------------------------------------ flash plan
SMS = (132, 8)
# (B, Hq, Hkv, T, kv_len, causal, q_offset, dh)
PLAN_SHAPES = [
    (4, 32, 32, 4096, 4096, True, 0, 64),  # stablelm prefill
    (4, 32, 32, 1, 4160, False, 4159, 64),  # stablelm decode
    (4, 48, 4, 1, 4160, False, 4159, 128),  # starcoder2 decode
    (1, 48, 4, 4096, 4096, True, 0, 128),  # starcoder2 prefill
    (2, 12, 1, 1, 4001, False, 4000, 128),  # 12:1 group, one block of rows
    (1, 8, 2, 12, 1000, True, 900, 128),  # causal short block
    (1, 4, 2, 5, 45, False, 40, 64),  # one kv tile
    (2, 4, 4, 1, 3000, False, 2000, 64),
    (1, 4, 1, 16, 64, True, 0, 64),  # 64 rows a kv head: 4 row blocks
    (3, 8, 2, 1, 0, False, 0, 64),  # empty cache
    (1, 2, 2, 17, 100, True, 83, 64),  # the shortest prefill block
]
PLAN_CASES = list(itertools.product(PLAN_SHAPES, (torch.bfloat16, torch.float32), SMS))


def _plan(shape, dtype, sms):
    B, Hq, Hkv, T, kv_len, causal, q_offset, dh = shape
    return fa_ops.plan(B, Hq, Hkv, T, kv_len, dtype, sms, causal=causal, q_offset=q_offset,
                       dh=dh)


def _kv_tiles(shape) -> int:
    _B, _Hq, _Hkv, T, kv_len, causal, q_offset, _dh = shape
    kv_end = min(kv_len, q_offset + T) if causal else kv_len
    return -(-kv_end // fa_ops.KV_TILE)


def _ids(c):
    shape, dtype, sms = c
    return "x".join(map(str, shape)) + f"-{str(dtype)[6:]}-{sms}sm"


@pytest.mark.parametrize("case", PLAN_CASES, ids=[_ids(c) for c in PLAN_CASES])
def test_flash_plan_splits_cover_the_kv_tiles(case):
    """Splits never exceed the kv tiles the rows see, no split is empty,
    and together they cover every tile; only short blocks split."""
    shape, dtype, sms = case
    p = _plan(shape, dtype, sms)
    n_tiles, T = _kv_tiles(shape), shape[3]
    assert p.grid[2] == p.splits >= 1 and p.tiles_per_split >= 1
    assert p.splits <= max(1, n_tiles)
    assert p.splits * p.tiles_per_split >= n_tiles
    if p.splits > 1:
        assert T <= fa_ops.SHORT_BLOCK
        assert (p.splits - 1) * p.tiles_per_split < n_tiles  # the last split has a tile


@pytest.mark.parametrize("case", PLAN_CASES, ids=[_ids(c) for c in PLAN_CASES])
def test_flash_plan_grid_and_scratch(case):
    """bf16 short blocks take the decode kernel with a grid over kv heads
    (and 16-row blocks of the group's T x Hq / Hkv rows); longer bf16
    blocks the prefill kernel over q heads; float32 the CUDA-core kernel.
    The scratch is what the merge kernel reads: (splits, B * Hq, T, dh + 2)."""
    shape, dtype, sms = case
    B, Hq, Hkv, T, _kv_len, _causal, _q_offset, dh = shape
    p = _plan(shape, dtype, sms)
    if dtype == torch.float32:
        assert p.variant == "f32"
        assert p.grid[:2] == (B * Hq, -(-T // (16 if T <= 16 else 64)))
    elif T <= fa_ops.SHORT_BLOCK:
        assert p.variant == "bf16_decode"
        assert p.grid[:2] == (B * Hkv, -(-T * (Hq // Hkv) // fa_ops.DECODE_ROWS))
    else:
        assert p.variant == "bf16_prefill"
        assert p.grid == (B * Hq, -(-T // fa_ops.PREFILL_ROWS[dh]), 1)
    want = (p.splits, B * Hq, T, dh + 2) if p.splits > 1 else None
    assert p.scratch == want


def test_flash_plan_decode_blocks_fill_the_card():
    """A decode step's B x Hkv blocks are split up to the target blocks
    an SM, and no further than the kv tiles allow."""
    p = fa_ops.plan(4, 32, 32, 1, 4160, torch.bfloat16, 132)
    assert p.grid[0] == 4 * 32 and p.grid[0] * p.splits >= 132
    p = fa_ops.plan(4, 48, 4, 1, 4160, torch.bfloat16, 132, dh=128)
    assert p.grid[:2] == (16, 1) and p.splits == -(-65 // p.tiles_per_split)
    assert fa_ops.plan(1, 4, 4, 1, 64, torch.bfloat16, 132).splits == 1  # one tile, no split


def test_flash_plan_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_ops.plan(1, 4, 4, 1, 64, torch.float16, 132)


def test_aligned16_copies_only_unaligned_operands():
    """The bf16 kernels copy whole 16-byte rows: a strided view whose rows
    are aligned is kept, a slice whose rows are not becomes a copy."""
    wide = torch.zeros(2, 40, 4, 72, dtype=torch.bfloat16)
    q = wide[..., :64].transpose(1, 2)  # rows 144 bytes apart: aligned
    assert fa_ops._aligned16(q) is q
    off = wide[..., 4:68].transpose(1, 2)  # 8 bytes in: not aligned
    got = fa_ops._aligned16(off)
    assert got is not off and got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, off)
    odd = torch.zeros(2, 4, 40, 65, dtype=torch.bfloat16)[..., :64]  # row stride 65
    assert fa_ops._aligned16(odd).is_contiguous()
