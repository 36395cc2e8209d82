"""The port's offline stage against the JAX package: the embedding (paper
step i), K-Means (the Lloyd step, `fit` and `fit_many` from an injected
identical init, since ``jax.random`` and ``torch.Generator`` draw
different seeds), the kmeans_assign plain version vs the JAX oracle and
the Pallas kernel (interpret mode), and the whole build by quality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as jemb
from repro.core import filtering as jfilt
from repro.core import kmeans as jkm
from repro.core import lmi as jlmi
from repro.kernels.kmeans_assign import ops as jka, ref as jka_ref
from repro_torch.core import embedding as pemb
from repro_torch.core import filtering as pfilt
from repro_torch.core import kmeans as pkm
from repro_torch.core import lmi as plmi
from repro_torch.kernels.kmeans_assign import ops as pka
from torch_parity import np_, perturbed_queries


def test_embedding_matches_jax(protein_ds):
    coords, lengths = protein_ds.coords[:96], protein_ds.lengths[:96]
    lengths = lengths.copy()
    lengths[:3] = [0, 1, 7]  # degenerate chains: empty, one residue, fewer than sections
    cfg = jemb.EmbeddingConfig()
    want = np.asarray(jemb.embed_batch(jnp.asarray(coords), jnp.asarray(lengths), cfg))
    got = np_(pemb.embed_batch(torch.from_numpy(coords), torch.from_numpy(lengths),
                               pemb.EmbeddingConfig()))
    assert got.shape == want.shape == (96, 45)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    one = np.asarray(jemb.section_means(jnp.asarray(coords[5]), jnp.asarray(lengths[5]), 10))
    np.testing.assert_allclose(np_(pemb.section_means(
        torch.from_numpy(coords[5:6]), torch.from_numpy(lengths[5:6]), 10))[0], one,
        atol=1e-4, rtol=1e-6)
    full = np_(pemb.embed_dataset(coords, lengths, pemb.EmbeddingConfig(), batch_size=40,
                                  device="cpu"))
    np.testing.assert_allclose(full, want, atol=1e-6, rtol=0)


def _blobs(seed, n, d=8, k=4, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(scale=spread, size=(n, d))).astype(np.float32)


def test_lloyd_step_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (300, 45)).astype(np.float32)
    c = x[rng.choice(300, 9, replace=False)] + 0.01
    w = (rng.uniform(size=300) > 0.2).astype(np.float32)
    c[3] = 5.0  # far away: an empty cluster, repaired to the farthest live point
    jc, jl, ji = jkm._lloyd_step(jnp.asarray(x), jnp.asarray(c), 9, jnp.asarray(w))
    pc, pl, pi = pkm._lloyd_step(torch.from_numpy(x), torch.from_numpy(c), 9,
                                 torch.from_numpy(w))
    np.testing.assert_array_equal(np_(pl), np.asarray(jl))
    np.testing.assert_allclose(np_(pc), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(pi), float(ji), rtol=1e-4)  # a sum over all points


def _lloyd_many_case():
    """Three groups of a padded level: zero-weight padding rows (copies of
    the first point, as `lmi._pad_groups` pads), a far centroid that ends
    empty (repaired to the farthest live point), groups of unequal size."""
    rng = np.random.default_rng(4)
    groups, cap, k, d = 3, 256, 9, 45
    xs = rng.uniform(0, 1, (groups, cap, d)).astype(np.float32)
    ws = np.zeros((groups, cap), np.float32)
    cs = np.empty((groups, k, d), np.float32)
    for g, live in enumerate((256, 170, 60)):
        ws[g, :live] = 1.0
        xs[g, live:] = xs[0, 0]
        cs[g] = xs[g, rng.choice(live, k, replace=False)] + 0.01
    cs[1, 4] = 5.0  # far away: empty
    return xs, ws, cs, k


def test_lloyd_step_many_matches_jax_vmap():
    """The batched step against ``jax.vmap`` of the reference's single-group
    step, at the single-group test's tolerances."""
    xs, ws, cs, k = _lloyd_many_case()
    step = jax.vmap(lambda x, c, w: jkm._lloyd_step(x, c, k, w))
    jc, jl, ji = step(jnp.asarray(xs), jnp.asarray(cs), jnp.asarray(ws))
    pc, pl, pi = pkm._lloyd_step_many(torch.from_numpy(xs), torch.from_numpy(cs), k,
                                      torch.from_numpy(ws))
    assert pl.dtype == torch.int32
    np.testing.assert_array_equal(np_(pl), np.asarray(jl))
    np.testing.assert_allclose(np_(pc), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(pi), np.asarray(ji), rtol=1e-4)  # sums over all points
    assert not np.allclose(np_(pc)[1, 4], 5.0)  # the empty cluster was repaired


def test_lloyd_sums_take_no_scatter_add(monkeypatch):
    """The per-cluster sums go through a product and a reduction with a
    fixed order, never a scatter-add, which adds by atomics on the card
    (a build there would not reproduce from its seed)."""
    def refuse(*args, **kw):
        raise AssertionError("scatter_add_ on the Lloyd path")

    monkeypatch.setattr(torch.Tensor, "scatter_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "scatter_add", refuse)
    monkeypatch.setattr(torch, "scatter_add", refuse)
    xs, ws, cs, k = _lloyd_many_case()
    pkm._lloyd_step_many(torch.from_numpy(xs), torch.from_numpy(cs), k, torch.from_numpy(ws))
    st = pkm.fit_many(None, torch.from_numpy(xs), torch.from_numpy(ws), k, max_iter=5,
                      init_centroids=torch.from_numpy(cs))
    assert tuple(st.centroids.shape) == cs.shape


@pytest.mark.parametrize("shape", [(518_576,), (3, 16_384), (2, 1025), (1, 7)])
def test_seeding_cdf_is_a_cumulative_sum(shape):
    """The seeding's fixed-order CDF (block scans plus a triangular product
    of the block totals) is the cumulative sum, to float32 rounding of the
    row's total."""
    p = torch.from_numpy(np.random.default_rng(8).uniform(size=shape).astype(np.float32))
    got = pkm._cdf(p)
    want = np.cumsum(np_(p).astype(np.float64), axis=-1)
    assert got.shape == p.shape and got.is_contiguous()
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=2e-6 * float(want[..., -1].max()))


def test_seeding_cdf_never_decreases():
    """Entries of no mass at every block start (points already chosen,
    padding rows) over the root's 1013 blocks: the block scans and the
    product of their totals add in different orders, and the CDF must not
    step down across a block boundary, or an entry of no mass is drawn."""
    rng = np.random.default_rng(10)
    p = torch.from_numpy((rng.uniform(size=(2, 518_576)) ** 8).astype(np.float32))
    p = p / p.sum(-1, keepdim=True)
    p[:, ::pkm._SCAN_BLOCK] = 0.0
    cdf = pkm._cdf(p)
    assert bool((cdf.diff(dim=-1) >= 0).all())
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = torch.stack([pkm._choice(gen, p) for _ in range(200)])
    assert bool((torch.gather(p, 1, draws.T) > 0).all())


def test_choice_draws_by_inverse_cdf():
    """Each row draws where its CDF first reaches the drawn level: only
    indices with mass, and index 0 for an all-zero row."""
    p = torch.zeros(4, 3000)
    p[1, 2500] = 1.0
    p[2, 600:620] = 1.0
    p[3] = 1.0
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = torch.stack([pkm._choice(gen, p) for _ in range(50)])
    assert bool((draws[:, 0] == 0).all()) and bool((draws[:, 1] == 2500).all())
    assert bool(((draws[:, 2] >= 600) & (draws[:, 2] < 620)).all())
    assert len(set(draws[:, 3].tolist())) > 40


def _init_first_rows(key, x, k, weights):  # the injected seeding: a group's first k rows
    return x[:k]


def test_fit_matches_jax_from_same_init(monkeypatch):
    x = _blobs(3, 400)
    x[1] = x[0]  # duplicate seeds: the second starts empty and is repaired
    monkeypatch.setattr(jkm, "_plusplus_init", _init_first_rows)
    jst = jkm.fit.__wrapped__(jax.random.PRNGKey(0), jnp.asarray(x), 6, max_iter=30)
    pst = pkm.fit(None, torch.from_numpy(x), 6, max_iter=30,
                  init_centroids=torch.from_numpy(x[:6]))
    assert int(pst.n_iter) == int(jst.n_iter)
    np.testing.assert_allclose(np_(pst.centroids), np.asarray(jst.centroids), atol=1e-5)
    np.testing.assert_allclose(float(pst.inertia), float(jst.inertia), rtol=1e-4)


def test_fit_many_matches_jax_from_same_init(monkeypatch):
    """Groups converge after different numbers of steps: each freezes on
    its own shift, as under JAX's vmap of the while_loop."""
    groups, cap = 5, 160
    xs = np.zeros((groups, cap, 8), np.float32)
    ws = np.zeros((groups, cap), np.float32)
    for g, n in enumerate((160, 90, 40, 12, 128)):
        xs[g, :n] = _blobs(10 + g, n, spread=0.02 + 0.03 * g)
        ws[g, :n] = 1.0
    monkeypatch.setattr(jkm, "_plusplus_init", _init_first_rows)
    monkeypatch.setattr(jkm, "fit", jkm.fit.__wrapped__)
    jst = jkm.fit_many(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(ws), 5,
                       max_iter=25)
    pst = pkm.fit_many(None, torch.from_numpy(xs), torch.from_numpy(ws), 5, max_iter=25,
                       init_centroids=torch.from_numpy(xs[:, :5]))
    np.testing.assert_array_equal(np_(pst.n_iter), np.asarray(jst.n_iter))
    assert len(set(np_(pst.n_iter).tolist())) > 1
    np.testing.assert_allclose(np_(pst.centroids), np.asarray(jst.centroids), atol=1e-5)
    # inertia: a float32 sum over every point, taken in another order
    np.testing.assert_allclose(np_(pst.inertia), np.asarray(jst.inertia), rtol=1e-4)


@pytest.mark.parametrize("n,k,d", [(300, 7, 45), (130, 128, 16), (64, 1, 3)])
def test_kmeans_assign_plain_matches_jax(n, k, d):
    rng = np.random.default_rng(n + k)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    c = rng.uniform(0, 1, (k, d)).astype(np.float32)
    c[-1] = c[0]  # a tied centroid pair: the lower index wins
    x[0] = c[0]
    wl, wm = (np.asarray(a) for a in jka_ref.kmeans_assign_ref(x, c))
    gl, gm = (np_(a) for a in pka.kmeans_assign_with_dist(torch.from_numpy(x),
                                                          torch.from_numpy(c)))
    assert gl.dtype == np.int32
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gm, wm, atol=1e-5, rtol=0)
    assert gm.min() >= 0.0 and gl[0] == 0
    np.testing.assert_array_equal(np_(pkm.assign(torch.from_numpy(x), torch.from_numpy(c))),
                                  np.asarray(jkm.assign(x, c)))


def test_kmeans_assign_plain_matches_pallas_kernel():
    """The Pallas kernel (interpret mode), which the CUDA kernel replaces."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (200, 45)).astype(np.float32)
    c = rng.uniform(0, 1, (20, 45)).astype(np.float32)
    wl, wm = (np.asarray(a) for a in jka.kmeans_assign_with_dist(x, c, interpret=True))
    gl, gm = (np_(a) for a in pka.kmeans_assign_with_dist(torch.from_numpy(x),
                                                          torch.from_numpy(c)))
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gm, wm, atol=1e-5, rtol=0)


def test_kmeans_assign_groups_match_per_group():
    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.uniform(0, 1, (3, 50, 12)).astype(np.float32))
    cs = torch.from_numpy(rng.uniform(0, 1, (3, 6, 12)).astype(np.float32))
    labels, mind = pka.kmeans_assign_with_dist(xs, cs)
    for g in range(3):
        wl, wm = jka_ref.kmeans_assign_ref(np_(xs[g]), np_(cs[g]))
        np.testing.assert_array_equal(np_(labels[g]), np.asarray(wl))
        np.testing.assert_allclose(np_(mind[g]), np.asarray(wm), atol=1e-5)


def test_pad_groups_and_assign_children_match_jax(small_lmi):
    x = np.array(small_lmi.sorted_embeddings)
    labels = np.random.default_rng(0).integers(0, 8, x.shape[0])
    jx, jw = jlmi._pad_groups(jnp.asarray(x), labels, 8, None, 8)
    px, pw = plmi._pad_groups(torch.from_numpy(x), labels, 8, None, 8)
    np.testing.assert_array_equal(np_(px), np.asarray(jx))
    np.testing.assert_array_equal(np_(pw), np.asarray(jw))
    params = small_lmi.levels[1]
    want = np.asarray(jlmi._assign_children("kmeans", params, jnp.asarray(x),
                                            jnp.asarray(labels, jnp.int32)))
    got = np_(plmi._assign_children(
        "kmeans", {"centroids": torch.from_numpy(np.asarray(params["centroids"]))},
        torch.from_numpy(x), torch.from_numpy(labels), chunk=100))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _recall(ids, truth):
    return float(np.mean([len(np.intersect1d(a[a >= 0], b)) / len(b)
                          for a, b in zip(np.asarray(ids), np.asarray(truth))]))


def test_build_quality_matches_jax_build(small_lmi, protein_embeddings):
    emb = np.asarray(protein_embeddings)
    pidx = plmi.build(0, torch.from_numpy(emb), arities=(8, 8), device="cpu")
    n = emb.shape[0]
    ids = np_(pidx.sorted_ids)
    np.testing.assert_array_equal(np.sort(ids), np.arange(n))  # each id in one bucket
    off = np_(pidx.bucket_offsets)
    assert off[0] == 0 and off[-1] == n and (np.diff(off) >= 0).all()
    assert pidx.max_bucket_size == int(np.diff(off).max())
    np.testing.assert_array_equal(np_(pidx.sorted_embeddings), emb[ids])
    # each row sits in the leaf its greedy level-by-level routing picks
    x = torch.from_numpy(emb[ids])
    root = torch.argmax(plmi._node_log_proba("kmeans", pidx.levels[0], x), dim=-1)
    child = torch.argmax(plmi._assign_children("kmeans", pidx.levels[1], x, root), dim=-1)
    leaf = np_(root * 8 + child)
    np.testing.assert_array_equal(leaf, np.repeat(np.arange(64), np.diff(off)))

    q = perturbed_queries(emb, 64)
    truth = np.asarray(jfilt.brute_force_knn(q, emb, 10)[0])
    jids, _ = jfilt.knn_query(small_lmi, q, k=10, stop_condition=0.05)
    pids, _ = pfilt.knn_query(pidx, torch.from_numpy(q), k=10, stop_condition=0.05)
    r_jax, r_port = _recall(jids, truth), _recall(pids, truth)
    assert r_port >= r_jax - 0.05, (r_port, r_jax)
    assert r_port > 0.5
