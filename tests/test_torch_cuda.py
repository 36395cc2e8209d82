"""The port's CUDA kernels against their plain versions, on a card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports nothing of JAX, so it runs on a
machine with a card and no JAX (``--noconftest`` skips the suite's
JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import filtering, lmi, store as store_lib
from repro_torch.kernels.kmeans_assign import ops as ka_ops, ref as ka_ref
from repro_torch.kernels.lmi_filter import ops as lf_ops, ref as lf_ref

pytestmark = pytest.mark.cuda

# the JAX suite's kernel tolerances (norm decomposition vs direct difference)
TOL = {"euclidean": 1e-4, "sq_euclidean": 1e-5, "cosine": 1e-5}
METRICS = tuple(TOL)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _runs_case(dev, seed=0, n_q=6, n_buckets=40, d=16, stop=60, cap=90):
    """Search outputs whose runs match rows / valid: ragged candidate
    counts, empty buckets inside the visited stream, fewer than 70
    candidates for some queries (exhausted top-70 slots)."""
    rng = np.random.default_rng(seed)
    sizes = torch.from_numpy(rng.integers(0, 9, n_buckets).astype(np.int32))
    sizes[[4, 9]] = 0
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32), torch.cumsum(sizes, 0).int()])
    emb = torch.from_numpy(rng.normal(size=(int(offsets[-1]), d)).astype(np.float32))
    logp = torch.from_numpy(rng.normal(size=(n_q, n_buckets)).astype(np.float32))
    order, visited, sz = lmi.rank_visited_buckets(logp, sizes, stop)
    rows, valid, _n = lmi.extract_rows(order, visited, offsets, cap)
    runs = lmi.BucketRuns(starts=offsets[order].int().to(dev),
                          lengths=torch.where(visited, sz, 0).int().to(dev))
    q = torch.from_numpy(rng.normal(size=(n_q, d)).astype(np.float32))
    return q.to(dev), emb.to(dev), rows.to(dev), valid.to(dev), runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
def test_filter_kernels_match_plain(dev, metric, dtype):
    q, emb, rows, valid, runs = _runs_case(dev, seed=13)
    data = emb.to(dtype)
    kd, ki = lf_ops.lmi_filter_topk(q, rows, valid, data, 70, metric=metric, runs=runs)
    rd, ri = lf_ref.lmi_filter_topk_ref(q, rows, valid, data, 70, metric=metric)
    fin = rd < 1e37
    assert bool((~fin).any()), "the case must exhaust some top-70 slots"
    torch.testing.assert_close(kd[fin], rd[fin], rtol=TOL[metric], atol=TOL[metric])
    assert torch.equal(ki[fin], ri[fin])  # random data: no near ties
    assert bool((ki[~fin] == -1).all()) and bool((kd[~fin] >= 1e37).all())
    kr = lf_ops.lmi_filter_range(q, rows, valid, data, metric=metric, runs=runs)
    rr = lf_ref.lmi_filter_ref(q, rows, valid, data, metric=metric)
    fin = rr < 1e37
    assert torch.equal(kr < 1e37, fin)
    torch.testing.assert_close(kr[fin], rr[fin], rtol=TOL[metric], atol=TOL[metric])


def test_filter_kernel_counts_launches_and_checks_operands(dev):
    q, emb, rows, valid, runs = _runs_case(dev, seed=3)
    before = dict(lf_ops.LAUNCHES)
    lf_ops.lmi_filter_topk(q, rows, valid, emb, 5, runs=runs)
    lf_ops.lmi_filter_range(q, rows, valid, emb, runs=runs)
    assert lf_ops.LAUNCHES["lmi_filter_topk_desc"] == before["lmi_filter_topk_desc"] + 1
    assert lf_ops.LAUNCHES["lmi_filter_range_desc"] == before["lmi_filter_range_desc"] + 1
    with pytest.raises(NotImplementedError, match="BucketRuns"):
        lf_ops.lmi_filter_topk(q, rows, valid, emb, 5)
    with pytest.raises(NotImplementedError, match="quantized"):
        lf_ops.lmi_filter_topk(q, rows, valid, emb.to(torch.float16), 5, runs=runs)
    with pytest.raises(ValueError):
        lf_ops.lmi_filter_range(q.cpu(), rows, valid, emb, runs=runs)


@pytest.mark.parametrize("n,k,d", [(5000, 256, 45), (2000, 300, 45), (700, 9, 100),
                                   (300, 5, 300)])
def test_kmeans_assign_kernel_matches_plain(dev, n, k, d):
    """Register tiles for d <= 64, <= 256 and <= 1024; k = 300 at d = 45
    streams the centroids through shared memory in two chunks."""
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.uniform(0, 1, (n, d)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.uniform(0, 1, (k, d)).astype(np.float32)).to(dev)
    c[-1] = c[0]  # a tied pair: the lower index must win
    x[0] = c[0]
    kl, km = ka_ops.kmeans_assign_with_dist(x, c)
    rl, rm = ka_ref.kmeans_assign_ref(x, c)
    torch.testing.assert_close(km, rm, rtol=1e-5, atol=1e-4)
    assert int(kl[0]) == 0 and bool((km >= 0).all())
    swapped = kl != rl  # only between centroids at (near-)equal distance
    gap = ((x - c[kl.long()]) ** 2).sum(-1) - ((x - c[rl.long()]) ** 2).sum(-1)
    assert float(gap[swapped].abs().max()) <= 1e-4 if bool(swapped.any()) else True


def test_kmeans_assign_kernel_groups(dev):
    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.uniform(0, 1, (3, 500, 12)).astype(np.float32)).to(dev)
    cs = torch.from_numpy(rng.uniform(0, 1, (3, 6, 12)).astype(np.float32)).to(dev)
    labels, mind = ka_ops.kmeans_assign_with_dist(xs, cs)
    for g in range(3):
        rl, rm = ka_ref.kmeans_assign_ref(xs[g], cs[g])
        assert torch.equal(labels[g], rl)
        torch.testing.assert_close(mind[g], rm, rtol=1e-5, atol=1e-5)


def test_build_and_query_on_card_match_cpu(dev):
    """A tiny index built on the card answers like the same index on the
    CPU (plain versions), modulo distance ties."""
    rng = np.random.default_rng(1)
    centers = rng.uniform(0, 1, (12, 45))
    x = (centers[rng.integers(0, 12, 3000)] + rng.normal(scale=0.05, size=(3000, 45)))
    x = torch.from_numpy(x.astype(np.float32))
    index = lmi.build(0, x.to(dev), arities=(8, 8), device=dev)
    sizes = index.bucket_sizes().cpu()
    assert int(sizes.sum()) == 3000
    assert torch.equal(torch.sort(index.sorted_ids.cpu()).values, torch.arange(3000).int())
    q = x[:64] + 0.01
    store = store_lib.from_lmi(index, "bfloat16")
    ids, d = filtering.knn_query(index, q.to(dev), k=10, stop_condition=0.05, store=store)
    cpu = index.to("cpu")
    cids, cd = filtering.knn_query(cpu, q, k=10, stop_condition=0.05,
                                   store=store_lib.from_lmi(cpu, "bfloat16"))
    assert filtering.knn_agree(ids.cpu(), d.cpu(), cids, cd, atol=2e-3).mean() >= 0.95
