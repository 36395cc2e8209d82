"""The port's candidate store, filter host side and query entry points
against the JAX package on the same inputs: descriptor operands, the
plain filter vs the JAX oracle and vs the Pallas descriptor kernels (in
interpret mode), and `knn_query` / `range_query` end to end on a
JAX-built index. The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py; `chip_smoke.py` holds them against the plain
version at the full shapes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filtering as jfilt
from repro.core import store as jstore
from repro.kernels.lmi_filter import ops as jops, ref as jref
from repro_torch.core import filtering as pfilt
from repro_torch.core import store as pstore
from repro_torch.kernels.lmi_filter import ops as pops
from torch_parity import (E2E_ATOL, TOL, np_, perturbed_queries, port_runs, runs_case,
                          to_port)

METRICS = ("euclidean", "sq_euclidean", "cosine")


def _stores(emb, dtype):
    """(JAX store rows, port store rows) at the store precision."""
    jdata = jstore.quantize(jnp.asarray(emb), dtype)[0]
    pdata = pstore.quantize(torch.from_numpy(emb), dtype)[0]
    return jdata, pdata


def test_run_descriptors_match_jax():
    for seed, cap in ((0, 48), (1, 30), (2, 7)):
        _q, _e, _o, _r, _v, runs = runs_case(seed, cap=max(cap, 30))
        want = jops._run_descriptors(runs, cap)
        got = pops._run_descriptors(port_runs(runs), cap)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np_(g), np.asarray(w))
        for g, w in zip(pops._pad_descriptors(port_runs(runs), cap, bq=8),
                        jops._pad_descriptors(runs, cap)):
            np.testing.assert_array_equal(np_(g), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_rows_bitwise_equal_jax(dtype):
    """bf16 rounding of the store is round-to-nearest-even in both."""
    rng = np.random.default_rng(4)
    emb = rng.uniform(0, 1, (300, 45)).astype(np.float32)
    emb[:5] = [[1.00390625], [1.01171875], [-0.0], [3.4e38], [1e-40]]  # ties, edge values
    jdata, pdata = _stores(emb, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(pdata.view(torch.int16).numpy(),
                                      np.asarray(jdata).view(np.int16))
    else:
        np.testing.assert_array_equal(pdata.numpy(), np.asarray(jdata))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_filter_matches_jax_ref(metric, dtype):
    q, emb, _o, rows, valid, _runs = runs_case(7)
    jdata, pdata = _stores(emb, dtype)
    want = np.asarray(jref.lmi_filter_ref(q, rows, valid, jdata, metric=metric))
    got = np_(pops.lmi_filter_range(torch.from_numpy(q), torch.from_numpy(rows),
                                    torch.from_numpy(valid), pdata, metric=metric))
    np.testing.assert_array_equal(got >= 1e37, want >= 1e37)
    fin = want < 1e37
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL[metric], atol=TOL[metric])
    wd, wi = jref.lmi_filter_topk_ref(q, rows, valid, jdata, 40, metric=metric)
    gd, gi = pops.lmi_filter_topk(torch.from_numpy(q), torch.from_numpy(rows),
                                  torch.from_numpy(valid), pdata, 40, metric=metric)
    wd, wi, gd, gi = np.asarray(wd), np.asarray(wi), np_(gd), np_(gi)
    fin = wd < 1e37
    assert (~fin).any(), "the case must exhaust some top-40 slots"
    np.testing.assert_array_equal(gd >= 1e37, ~fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=TOL[metric], atol=TOL[metric])
    np.testing.assert_array_equal(gi[fin], wi[fin])  # random data: no near ties


@pytest.mark.parametrize("kernel,dtype,metric", [
    ("topk", "bfloat16", "euclidean"),
    ("range", "float32", "cosine"),
])
def test_plain_filter_matches_pallas_desc_kernel(kernel, dtype, metric):
    """The Pallas descriptor kernels (interpret mode) — what the CUDA
    kernels replace — agree with the port's plain filter."""
    q, emb, _o, rows, valid, runs = runs_case(9)
    jdata, pdata = _stores(emb, dtype)
    args = (torch.from_numpy(q), torch.from_numpy(rows), torch.from_numpy(valid), pdata)
    if kernel == "range":
        want = np.asarray(jops.lmi_filter_range(q, rows, valid, jdata, metric=metric,
                                                interpret=True, runs=runs))
        got = np_(pops.lmi_filter_range(*args, metric=metric, runs=port_runs(runs)))
        np.testing.assert_array_equal(got >= 1e37, want >= 1e37)
        fin = want < 1e37
        np.testing.assert_allclose(got[fin], want[fin], rtol=TOL[metric], atol=TOL[metric])
        return
    wd, wi = (np.asarray(a) for a in jops.lmi_filter_topk(
        q, rows, valid, jdata, 40, metric=metric, interpret=True, runs=runs))
    gd, gi = (np_(a) for a in pops.lmi_filter_topk(*args, 40, metric=metric,
                                                    runs=port_runs(runs)))
    fin = wd < 1e37
    assert (wi[~fin] == -1).all() and (~fin).any()
    np.testing.assert_array_equal(gd >= 1e37, ~fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=TOL[metric], atol=TOL[metric])
    np.testing.assert_array_equal(gi[fin], wi[fin])


def _e2e(small_lmi, n=24):
    return to_port(small_lmi), perturbed_queries(small_lmi.sorted_embeddings, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_query_matches_jax(small_lmi, metric, dtype):
    pidx, q = _e2e(small_lmi)
    jst = jstore.from_lmi(small_lmi, dtype)
    pst = pstore.from_lmi(pidx, dtype)
    jids, jd = jfilt.knn_query(small_lmi, q, k=10, stop_condition=0.05, metric=metric,
                               store=jst)
    pids, pd = pfilt.knn_query(pidx, torch.from_numpy(q), k=10, stop_condition=0.05,
                               metric=metric, store=pst)
    assert pids.shape == (len(q), 10) and pids.dtype == torch.int32
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=E2E_ATOL).all()


def test_knn_query_k_above_capacity(small_lmi):
    """k > candidate capacity: the filter is clamped and the tail padded
    with not-found slots, as in the JAX plan."""
    pidx, q = _e2e(small_lmi)
    jids, jd = jfilt.knn_query(small_lmi, q, k=30, candidate_cap=20, stop_condition=0.01)
    pids, pd = pfilt.knn_query(pidx, torch.from_numpy(q), k=30, candidate_cap=20,
                               stop_condition=0.01)
    assert (np_(pids)[:, 20:] == -1).all() and np.isinf(np_(pd)[:, 20:]).all()
    np.testing.assert_array_equal(np_(pids) == -1, np.asarray(jids) == -1)
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=E2E_ATOL).all()


def test_knn_query_max_radius(small_lmi):
    pidx, q = _e2e(small_lmi)
    jids, jd = jfilt.knn_query(small_lmi, q, k=10, stop_condition=0.05, max_radius=0.1,
                               radius_scale=1.5)
    pids, pd = pfilt.knn_query(pidx, torch.from_numpy(q), k=10, stop_condition=0.05,
                               max_radius=0.1, radius_scale=1.5)
    assert (np_(pids) == -1).any() and (np_(pids) >= 0).any()
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=E2E_ATOL).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_range_query_matches_jax(small_lmi, metric):
    pidx, q = _e2e(small_lmi)
    radius = 0.2 if metric == "euclidean" else 0.01
    jr = jfilt.range_query(small_lmi, q, radius, stop_condition=0.05, metric=metric,
                           radius_scale=1.5)
    pr = pfilt.range_query(pidx, torch.from_numpy(q), radius, stop_condition=0.05,
                           metric=metric, radius_scale=1.5)
    jd, pd = np.asarray(jr.distances), np_(pr.distances)
    np.testing.assert_array_equal(pd >= 1e37, jd >= 1e37)
    fin = jd < 1e37
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=0, atol=E2E_ATOL)
    near = np.abs(jd - radius * 1.5) <= E2E_ATOL
    np.testing.assert_array_equal(np_(pr.mask) | near, np.asarray(jr.mask) | near)
    assert np_(pr.mask).any()
    ok = np_(pr.mask) & np.asarray(jr.mask)
    np.testing.assert_array_equal(np_(pr.ids)[ok], np.asarray(jr.ids)[ok])


def test_brute_force_matches_jax(small_lmi):
    db = np.asarray(small_lmi.sorted_embeddings)
    q = perturbed_queries(db, 8)
    for metric in METRICS:
        np.testing.assert_allclose(
            np_(pfilt.brute_force_distances(torch.from_numpy(q), torch.from_numpy(db), metric)),
            np.asarray(jfilt.brute_force_distances(q, db, metric=metric)), atol=1e-4, rtol=0)
    jid, jd = jfilt.brute_force_knn(q, db, 10)
    pid, pd = pfilt.brute_force_knn(torch.from_numpy(q), torch.from_numpy(db), 10)
    assert pfilt.knn_agree(pid, pd, jid, jd, atol=1e-4).all()


def test_store_api(small_lmi):
    pidx = to_port(small_lmi)
    st = pstore.from_lmi(pidx, "bfloat16")
    assert st.dtype == "bfloat16" and st.data.dtype == torch.bfloat16
    assert st.nbytes(include_metadata=False) == pidx.n_objects * pidx.dim * 2
    assert pstore.row_scales(st) is None
    rows = torch.tensor([[0, 5], [7, 1]])
    np.testing.assert_array_equal(np_(pstore.dequantize_rows(st, rows)),
                                  np_(st.data[rows].float()))
    assert pstore.refresh(pidx, st).dtype == "bfloat16"
    with pytest.raises(ValueError, match="store dtype"):
        pstore.validate_dtype("float16")
    with pytest.raises(ValueError, match="granularity"):
        pstore.validate_granularity("tile")
    for dtype in pstore.QUANTIZED_DTYPES:  # built since the quantized slice
        qst = pstore.from_lmi(pidx, dtype)
        assert qst.dtype == dtype and pstore.row_scales(qst).shape == (pidx.n_objects,)
    import dataclasses

    stale = dataclasses.replace(pidx, index_revision=1)
    with pytest.raises(ValueError, match="stale CandidateStore"):
        pfilt.knn_query(stale, torch.zeros((1, pidx.dim)), k=3, store=st)


def test_knn_agree_flags_real_differences():
    ids = np.array([[1, 2, 3]])
    d = np.array([[0.1, 0.2, 0.3]])
    assert pfilt.knn_agree(ids, d, ids, d, 1e-3).all()
    assert pfilt.knn_agree(ids, d, np.array([[1, 2, 4]]), d, 1e-3).all()  # tie at the cut
    assert not pfilt.knn_agree(ids, d, np.array([[1, 4, 3]]), np.array([[0.1, 0.2, 0.3]]),
                               1e-3).all()
    assert not pfilt.knn_agree(ids, d, ids, d + 0.01, 1e-3).all()
