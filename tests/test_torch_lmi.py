"""The port's routing and candidate extraction (`repro_torch.core.lmi`)
against the JAX package on the same index: the leaf log-prob panel of
every node-model family, the best-first ranking and stop-condition cut,
the CSR rows / validity and the bucket runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lmi as jlmi
from repro_torch.core import lmi as plmi
from torch_parity import FAMILIES, LOGP_ATOL, np_, perturbed_queries, random_jax_index, to_port


def _case(family, arities, seed=0):
    jidx = random_jax_index(seed, family, arities)
    q = perturbed_queries(jidx.sorted_embeddings, 24, seed=seed + 1, scale=0.05)
    return jidx, to_port(jidx), q


@pytest.mark.parametrize("arities", [(8, 8), (4, 4, 4)])
@pytest.mark.parametrize("family", FAMILIES)
def test_leaf_log_probs_match_jax(family, arities):
    jidx, pidx, q = _case(family, arities)
    want = np.asarray(jlmi.leaf_log_probs(jidx, q))
    got = np_(plmi.leaf_log_probs(pidx, torch.from_numpy(q)))
    assert got.shape == want.shape == (24, int(np.prod(arities)))
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_temperatures_match_jax(family):
    jidx, pidx, q = _case(family, (4, 4, 4), seed=3)
    temps = (0.7, 1.3, 0.5)
    want = np.asarray(jlmi.leaf_log_probs(jidx, q, temperatures=temps))
    got = np_(plmi.leaf_log_probs(pidx, torch.from_numpy(q), temperatures=temps))
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL, rtol=0)


@pytest.mark.parametrize("bucket_topk", [None, 10])
@pytest.mark.parametrize("arities", [(8, 8), (4, 4, 4)])
@pytest.mark.parametrize("family", FAMILIES)
def test_search_core_matches_jax(family, arities, bucket_topk):
    """Rows, valid, n_buckets/n_cands and runs equal JAX's wherever the two
    rankings agree; where they differ, only leaves tied in JAX's own
    log-probs (within float noise) may swap."""
    jidx, pidx, q = _case(family, arities, seed=5)
    stop_count, cap = jlmi.query_plan_params(jidx, 0.05)
    assert plmi.query_plan_params(pidx, 0.05) == (stop_count, cap)
    j = jlmi._search_core(jidx, jnp.asarray(q), stop_count, cap, bucket_topk)
    p = plmi._search_core(pidx, torch.from_numpy(q), stop_count, cap, bucket_topk)
    logp = np.asarray(jlmi.leaf_log_probs(jidx, q))
    jorder = np.asarray(jlmi.rank_visited_buckets(
        jnp.asarray(logp), jidx.bucket_sizes(), stop_count, bucket_topk)[0])
    porder = np_(plmi.rank_visited_buckets(
        torch.from_numpy(logp), pidx.bucket_sizes(), stop_count, bucket_topk)[0])
    np.testing.assert_array_equal(porder, jorder)  # same panel -> identical ranking
    (jids, jrows, jvalid, jnb, jnc, jruns) = [np.asarray(a) for a in j[:5]] + [j[5]]
    pids, prows, pvalid, pnb, pnc, pruns = [np_(a) for a in p[:5]] + [p[5]]
    assert prows.dtype == np.int32 and pnc.dtype == np.int32 and pnb.dtype == np.int32
    # the port's own ranking, read under JAX's panel, must be JAX's up to ties
    pown = np_(plmi.rank_visited_buckets(plmi.leaf_log_probs(pidx, torch.from_numpy(q)),
                                         pidx.bucket_sizes(), stop_count, bucket_topk)[0])
    np.testing.assert_allclose(np.take_along_axis(logp, pown, 1),
                               np.take_along_axis(logp, jorder, 1), atol=LOGP_ATOL, rtol=0)
    same = np.all(pown == jorder, axis=1)
    assert same.mean() > 0.8
    for a, b in ((pids, jids), (prows, jrows), (pvalid, jvalid), (pnb, jnb), (pnc, jnc),
                 (np_(pruns.starts), np.asarray(jruns.starts)),
                 (np_(pruns.lengths), np.asarray(jruns.lengths))):
        np.testing.assert_array_equal(a[same], b[same])


def test_extract_rows_matches_jax():
    rng = np.random.default_rng(11)
    sizes = rng.integers(0, 7, 40)
    sizes[[3, 17]] = 0  # empty buckets visited mid-stream
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    order = np.stack([rng.permutation(40) for _ in range(6)]).astype(np.int32)
    for stop, cap in ((1, 9), (12, 30), (50, 64)):
        jsz, jvis = jlmi._visited_cut(jnp.asarray(order), jnp.asarray(sizes, jnp.int32), stop)
        psz, pvis = plmi._visited_cut(torch.from_numpy(order).long(),
                                      torch.from_numpy(sizes.astype(np.int32)), stop)
        np.testing.assert_array_equal(np_(pvis), np.asarray(jvis))
        want = jlmi.extract_rows(jnp.asarray(order), jvis, jnp.asarray(offsets), cap)
        got = plmi.extract_rows(torch.from_numpy(order).long(), pvis,
                                torch.from_numpy(offsets), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_(g), np.asarray(w))


def test_search_entry_points(small_lmi):
    pidx = to_port(small_lmi)
    q = perturbed_queries(small_lmi.sorted_embeddings, 16)
    jr = jlmi.search(small_lmi, q, stop_condition=0.05)
    pr = plmi.search(pidx, torch.from_numpy(q), stop_condition=0.05)
    np.testing.assert_array_equal(np_(pr.n_candidates), np.asarray(jr.n_candidates))
    np.testing.assert_array_equal(np_(pr.valid), np.asarray(jr.valid))
    cids, rows, valid = plmi.search_rows(pidx, torch.from_numpy(q), stop_condition=0.05)
    jc, jrw, jv = jlmi.search_rows(small_lmi, q, stop_condition=0.05)
    np.testing.assert_array_equal(np_(rows), np.asarray(jrw))
    np.testing.assert_array_equal(np_(cids), np.asarray(jc))


def test_normalizers_match_jax():
    for bw in (None, 4, (8, 2)):
        assert plmi.normalize_beam_widths(bw, 3) == jlmi.normalize_beam_widths(bw, 3)
    for t in (None, 0.5, (1.0, 0.7, 0.5)):
        assert plmi.normalize_temperatures(t, 3) == jlmi.normalize_temperatures(t, 3)
    with pytest.raises(ValueError):
        plmi.normalize_beam_widths((1, 2, 3), 3)
    with pytest.raises(ValueError):
        plmi.normalize_temperatures((1.0, -1.0), 2)


def test_beam_is_not_ported_yet(small_lmi):
    pidx = to_port(small_lmi)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plmi.search(pidx, torch.zeros((2, pidx.dim)), beam_width=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plmi.build(0, pidx.sorted_embeddings, arities=(4, 4), model_type="gmm", device="cpu")
