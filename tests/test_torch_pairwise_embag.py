"""The port's pairwise_l2 and embedding_bag entry points (CPU tensors run
their plain versions) against the JAX package's Pallas kernels in
interpret mode, on the same inputs made with numpy from a seed; and the
recsys embedding substrate against ``repro.models.recsys``.

Tolerances: pairwise_l2 at the JAX suite's own bound (rtol 1e-4, atol
1e-3: the Pallas kernel's norm decomposition against the port's direct
difference, both float32 sums; bfloat16 inputs are exact in float32, so
the same bound holds). embedding_bag at rtol / atol 1e-5: float32 sums of
at most 50 rows in another order (JAX: counts @ table; port: gather and
sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jeb_ops
from repro.kernels.pairwise_l2 import ops as jpw_ops
from repro.models import recsys as jrecsys
from repro_torch.kernels.embedding_bag import ops as peb_ops
from repro_torch.kernels.pairwise_l2 import ops as ppw_ops
from repro_torch.models import recsys as precsys

PW_TOL = dict(rtol=1e-4, atol=1e-3)
EB_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(a: np.ndarray, dtype: str):
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


# -------------------------------------------------------------- pairwise_l2
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,m,d", [(8, 8, 4), (300, 200, 45), (17, 3, 130), (1, 129, 1)])
def test_pairwise_l2_matches_jax_pallas(n, m, d, dtype):
    """Ragged n, m and d (JAX pads them to 128; the port's kernel masks)."""
    rng = np.random.default_rng(n * 31 + m + d)
    jx, px = _pair(rng.normal(size=(n, d)).astype(np.float32), dtype)
    jy, py = _pair(rng.normal(size=(m, d)).astype(np.float32), dtype)
    want = np.asarray(jpw_ops.pairwise_l2(jx, jy, interpret=True))
    got = ppw_ops.pairwise_l2(px, py)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
    np.testing.assert_allclose(got.numpy(), want, **PW_TOL)


def test_pairwise_l2_self_distance_is_zero():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(50, 45)).astype(np.float32))
    d = ppw_ops.pairwise_l2(x, x)
    assert float(d.diagonal().abs().max()) < 1e-3 and bool((d >= 0).all())


def test_pairwise_l2_refuses_other_devices():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ppw_ops.pairwise_l2(torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"))


# ------------------------------------------------------------ embedding_bag
def _bag_case(seed: int, b=37, l=50, v=1000, d=72):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    ids[:, 1] = ids[:, 0]  # duplicate ids in every bag
    ids[2, : l // 4] = ids[2, l // 4]  # a bag with many copies of one id
    w = rng.uniform(0.1, 2.0, (b, l)).astype(np.float32)
    return table, ids, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_matches_jax_pallas(dtype, mode, weighted):
    table, ids, w = _bag_case(0)
    jt, pt = _pair(table, dtype)
    jw, pw = (jnp.asarray(w), torch.from_numpy(w)) if weighted else (None, None)
    want = np.asarray(jeb_ops.embedding_bag(jt, jnp.asarray(ids), jw, mode=mode, interpret=True))
    got = peb_ops.embedding_bag(pt, torch.from_numpy(ids), pw, mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (ids.shape[0], table.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **EB_TOL)


def test_embedding_bag_out_of_range_ids_add_nothing():
    """As in JAX's multi-hot kernel, where such an id matches no lane."""
    table, ids, w = _bag_case(1, b=4, l=8, v=100, d=16)
    bad = ids.copy()
    bad[0, 3], bad[1, 0] = -1, 100
    got = peb_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(bad), torch.from_numpy(w))
    keep = w.copy()
    keep[0, 3] = keep[1, 0] = 0.0
    want = np.asarray(jeb_ops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                            jnp.asarray(keep), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **EB_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_bag_lookup_matches_jax(use_kernel):
    """recsys.bag_lookup, plain and through the kernel entry point, against
    JAX's with use_kernel=True (the Pallas kernel, interpret mode)."""
    table, ids, w = _bag_case(2)
    want = np.asarray(jrecsys.bag_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w),
                                         use_kernel=True))
    got = precsys.bag_lookup(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(w),
                             use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), want, **EB_TOL)


def test_field_offsets_and_lookup_match_jax():
    vocabs = (7, 30, 1, 12)
    np.testing.assert_array_equal(precsys.field_offsets(vocabs).numpy(),
                                  np.asarray(jrecsys.field_offsets(vocabs)))
    rng = np.random.default_rng(3)
    weight = rng.normal(size=(512, 8)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, 5) for v in vocabs], axis=1).astype(np.int32)
    want = np.asarray(jrecsys.lookup(jnp.asarray(weight), vocabs, jnp.asarray(ids)))
    got = precsys.lookup(torch.from_numpy(weight), vocabs, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_tables_shape_and_scale():
    """JAX's padding to a multiple of 512 rows and its normal x dim**-0.5."""
    t = precsys.init_tables(0, (1000, 300), 16, device="cpu")
    assert tuple(t.shape) == (1536, 16) and t.dtype == torch.float32
    assert abs(float(t.std()) - 16 ** -0.5) < 0.01
    assert torch.equal(t, precsys.init_tables(0, (1000, 300), 16, device="cpu"))
