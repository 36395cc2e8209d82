"""The port's beam-pruned search against the JAX package on the same
inputs: canonical planes, the plain segmented node evaluation (vs the JAX
oracle and vs the Pallas kernel in interpret mode), `beam_leaf_ranking`
in both node-eval modes, beam `knn_query` / `range_query` with and
without prebuilt planes, the planes checkpoint in both directions, and
both CLIs, including `serve` following the meta's beam and temperatures.
The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py)."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filtering as jfilt
from repro.core import lmi as jlmi
from repro.core import planes as jplanes
from repro.kernels.beam_eval import ops as jbe
from repro.launch import build_index as jbuild
from repro_torch import index_io
from repro_torch.core import filtering as pfilt
from repro_torch.core import lmi as plmi
from repro_torch.core import planes as pplanes
from repro_torch.kernels.beam_eval import ops as pbe
from repro_torch.launch import build_index as pbuild, serve as pserve
from torch_parity import (E2E_ATOL, FAMILIES, LOGP_ATOL, TOL, jax_serve_answers, np_,
                          perturbed_queries, random_jax_index, random_params, to_port)

TEMPS3 = (1.0, 0.8, 0.7)


@functools.cache
def _indexes(seed, family, arities, n, d):
    """(JAX index, the port's copy of it), built once per module."""
    jidx = random_jax_index(seed, family, arities, n=n, d=d)
    return jidx, to_port(jidx)


def _planes_pair(family, temperature, seed, n, a, d):
    rng = np.random.default_rng(seed)
    params = random_params(rng, family, (n,), a, d)
    jp = jbe.family_planes(family, {k: jnp.asarray(v) for k, v in params.items()},
                           temperature=temperature)
    pp = pbe.family_planes(family, {k: torch.from_numpy(v) for k, v in params.items()},
                           temperature=temperature)
    return jp, pp


# ------------------------------------------------------------ 1. planes


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_planes_match_jax(family, temperature):
    rng = np.random.default_rng(0)
    params = random_params(rng, family, (6,), 5, 12)
    jp = jbe.family_planes(family, {k: jnp.asarray(v) for k, v in params.items()},
                           temperature=temperature)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    pp = pbe.family_planes(family, tparams, temperature=temperature)
    # the matrices are one float32 operation per entry in both packages
    for a, b in zip(pp.mats, jp.mats, strict=True):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    # vector planes are sums over d, which XLA and PyTorch may add in
    # another order
    for a, b in zip(pp.vecs, jp.vecs, strict=True):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    if temperature == 1.0 and family == "kmeans":  # T = 1 skips the scaling
        assert torch.equal(pp.mats[0], tparams["centroids"])


# ------------------------------------------------------- 2. node_scores


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("family", FAMILIES)
def test_node_scores_match_jax(family, temperature):
    """Ragged P = Q * F with long shared runs, against the JAX oracle;
    at T = 0.7 also against the Pallas kernel in interpret mode."""
    jp, pp = _planes_pair(family, temperature, seed=1, n=23, a=5, d=13)
    rng = np.random.default_rng(2)
    nq, f = 6, 9
    q = rng.uniform(0, 1, (nq, 13)).astype(np.float32)
    prefix = rng.integers(0, 23, (nq, f)).astype(np.int32)
    prefix[:, : f // 2] = prefix[0, 0]  # long shared runs
    got = np_(pbe.node_scores(torch.from_numpy(q), torch.from_numpy(prefix), pp, family,
                              temperature=temperature))
    assert got.shape == (nq, f, 5)
    want = np.asarray(jbe.node_scores(jnp.asarray(q), jnp.asarray(prefix), jp, family,
                                      use_kernel=False, temperature=temperature))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGP_ATOL)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-4)
    if temperature != 1.0:
        ker = np.asarray(jbe.node_scores(jnp.asarray(q), jnp.asarray(prefix), jp, family,
                                         use_kernel=True, interpret=True,
                                         temperature=temperature))
        np.testing.assert_allclose(got, ker, rtol=0, atol=LOGP_ATOL)


def test_segment_stats_counts():
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 40, (16, 12))
    prefix[:, :6] = 7
    for family in FAMILIES:
        got = pbe.segment_stats(prefix, family, 8, 13, 40)
        want = jbe.segment_stats(prefix, family, 8, 13, 40)
        for key in ("n_pairs", "n_touched_nodes", "gather_bytes", "vec_bytes", "planes_bytes"):
            assert got[key] == want[key], key
        # sorted, each touched node is one run; a tile boundary may split one
        n_tiles = -(-prefix.size // pbe.TILE_PAIRS)
        assert got["n_touched_nodes"] <= got["n_param_loads"] <= got["n_touched_nodes"] + n_tiles
        assert pbe.segment_stats(prefix, family, 8, 13, 40, prebuilt_planes=True)[
            "planes_bytes"] == 0


# ------------------------------------------------- 3. beam_leaf_ranking


def _ranking_agrees(p_order, p_logp, j_order, j_logp):
    """Equal up to ties: the same leaf set per query, the log-probs within
    LOGP_ATOL position by position, and every leaf the port ranks at a
    position carries (in JAX) the log-prob JAX has at that position."""
    p_order, p_logp = np_(p_order), np_(p_logp)
    j_order, j_logp = np.asarray(j_order), np.asarray(j_logp)
    assert p_order.shape == j_order.shape
    np.testing.assert_array_equal(np.sort(p_order, 1), np.sort(j_order, 1))
    np.testing.assert_allclose(p_logp, j_logp, rtol=0, atol=LOGP_ATOL)
    for i in range(j_order.shape[0]):
        lp = dict(zip(j_order[i].tolist(), j_logp[i].tolist()))
        at = np.array([lp[leaf] for leaf in p_order[i].tolist()])
        np.testing.assert_allclose(at, j_logp[i], rtol=0, atol=LOGP_ATOL)


@pytest.mark.parametrize("node_eval", plmi.NODE_EVAL_MODES)
@pytest.mark.parametrize("arities", [(16, 16), (8, 8, 8)])
@pytest.mark.parametrize("family", FAMILIES)
def test_beam_leaf_ranking_matches_jax(family, arities, node_eval):
    jidx, pidx = _indexes(3, family, arities, 400, 12)
    q = perturbed_queries(jidx.sorted_embeddings, 8)
    schedule = (6,) if len(arities) == 2 else (6, 3)
    # a scalar beam uncalibrated, and a schedule with temperatures
    for beam, temps in ((4, None), (schedule, TEMPS3[:len(arities)])):
        j_order, j_logp = jax.jit(functools.partial(
            jlmi.beam_leaf_ranking, beam_width=beam, node_eval=node_eval,
            temperatures=temps))(jidx, q)  # one compile, not one per eager op
        p_order, p_logp = plmi.beam_leaf_ranking(pidx, torch.from_numpy(q), beam,
                                                 node_eval=node_eval, temperatures=temps)
        width_last = beam if isinstance(beam, int) else beam[-1]
        assert p_order.shape[1] == min(width_last, math.prod(arities[:-1])) * arities[-1]
        _ranking_agrees(p_order, p_logp, j_order, j_logp)


# ----------------------------------------------- 4. wide beam == exact


@pytest.mark.parametrize("node_eval", plmi.NODE_EVAL_MODES)
def test_wide_beam_equals_exact(node_eval):
    _jidx, pidx = _indexes(3, "gmm", (8, 8, 8), 400, 12)
    q = torch.from_numpy(perturbed_queries(np_(pidx.sorted_embeddings), 6))
    for temps in (None, TEMPS3):
        order, logp = plmi.beam_leaf_ranking(pidx, q, 64, node_eval=node_eval,
                                             temperatures=temps)
        panel = plmi.leaf_log_probs(pidx, q, temps)
        want = torch.sort(-panel, dim=-1, stable=True).indices
        assert torch.equal(order, want)
        assert torch.equal(logp, torch.gather(panel, 1, want))


# ---------------------------------------- 5. knn / range with a beam


@pytest.mark.parametrize("prebuilt", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_beam_queries_match_jax(family, prebuilt):
    jidx, pidx = _indexes(6, family, (8, 8, 8), 600, 12)
    q = perturbed_queries(jidx.sorted_embeddings, 8)
    kw = dict(beam_width=(6, 3), node_eval="segmented", temperatures=TEMPS3,
              stop_condition=0.05)
    jpl = jplanes.from_lmi(jidx, TEMPS3) if prebuilt else None
    ppl = pplanes.from_lmi(pidx, TEMPS3) if prebuilt else None
    jids, jd = jfilt.knn_query(jidx, q, k=10, planes=jpl, **kw)
    pids, pd = pfilt.knn_query(pidx, torch.from_numpy(q), k=10, planes=ppl, **kw)
    assert (np_(pids)[:, 0] >= 0).all()
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=TOL["euclidean"]).all()
    jr = jfilt.range_query(jidx, q, 0.3, planes=jpl, **kw)
    pr = pfilt.range_query(pidx, torch.from_numpy(q), 0.3, planes=ppl, **kw)
    jdist, pdist = np.asarray(jr.distances), np_(pr.distances)
    np.testing.assert_array_equal(pdist >= 1e37, jdist >= 1e37)
    fin = jdist < 1e37
    np.testing.assert_allclose(pdist[fin], jdist[fin], rtol=0, atol=E2E_ATOL)
    assert np_(pr.mask).any()


# ------------------------------------------------ 6. planes.validate


def test_planes_validate_errors():
    jidx = random_jax_index(7, "kmeans", (4, 4, 4), n=200, d=12)
    pidx = to_port(jidx)
    q = torch.from_numpy(perturbed_queries(jidx.sorted_embeddings, 2))
    planes = pplanes.from_lmi(pidx)
    kw = dict(k=3, beam_width=4, node_eval="segmented")
    stale = dataclasses.replace(pidx, index_revision=1)
    with pytest.raises(ValueError, match="stale IndexPlanes"):
        pfilt.knn_query(stale, q, planes=planes, **kw)
    with pytest.raises(ValueError, match="stale IndexPlanes"):
        jfilt.knn_query(dataclasses.replace(jidx, index_revision=1), np_(q),
                        planes=jplanes.from_lmi(jidx), **kw)
    refreshed = pplanes.refresh(stale, planes)
    assert refreshed.revision == 1
    ids, _d = pfilt.knn_query(stale, q, planes=refreshed, **kw)
    assert (np_(ids)[:, 0] >= 0).all()
    with pytest.raises(ValueError, match="folded with temperatures"):
        pfilt.knn_query(pidx, q, planes=planes, temperatures=TEMPS3, **kw)
    with pytest.raises(ValueError, match="folded with temperatures"):
        plmi.search(pidx, q, planes=planes, temperatures=TEMPS3, beam_width=4,
                    node_eval="segmented")
    with pytest.raises(ValueError, match="prunable levels"):
        pplanes.validate(pidx, dataclasses.replace(planes, levels=planes.levels[:1]))
    with pytest.raises(ValueError, match="node_eval"):
        pfilt.knn_query(pidx, q, k=3, beam_width=4, node_eval="bogus")
    with pytest.raises(ValueError, match="node_eval"):
        pfilt.range_query(pidx, q, 0.1, node_eval="bogus")
    assert planes.depth == 3 and planes.level_planes(2) is planes.levels[1]
    assert planes.nbytes() == sum(t.numel() * 4 for pl in planes.levels
                                  for t in (*pl.mats, *pl.vecs))
    assert planes.to("cpu").levels[0].mats[0].device.type == "cpu"


# ------------------------------------------------ 7. planes checkpoint


def _assert_same_planes(pp, jp):
    assert tuple(pp.temperatures) == tuple(jp.temperatures) and pp.revision == jp.revision
    assert len(pp.levels) == len(jp.levels)
    for a, b in zip(pp.levels, jp.levels):
        for x, y in zip(a.mats + a.vecs, b.mats + b.vecs):
            np.testing.assert_array_equal(np_(x), np.asarray(y))


@pytest.mark.parametrize("family", FAMILIES)
def test_planes_checkpoint_both_ways(tmp_path, family):
    jidx = random_jax_index(8, family, (4, 4, 4), n=200, d=45)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jbuild.save_index(str(jdir), jidx, n_sections=10, cutoff=50.0, prebuilt_planes=True,
                      temperatures=TEMPS3)
    pidx = index_io.load_index(str(jdir), device="cpu")
    _assert_same_planes(index_io.load_planes(str(jdir), pidx),
                        jbuild.load_planes(str(jdir), jbuild.load_index(str(jdir))))
    index_io.save_index(str(pdir), pidx, n_sections=10, cutoff=50.0, prebuilt_planes=True,
                        temperatures=TEMPS3, beam_widths=(4, 2), node_eval="segmented")
    ported = index_io.load_planes(str(pdir), pidx)
    _assert_same_planes(ported, jbuild.load_planes(str(pdir), jbuild.load_index(str(pdir))))
    _assert_same_planes(ported, pplanes.from_lmi(pidx, TEMPS3))
    meta = index_io.load_meta(str(pdir))
    assert index_io.serving_defaults(meta) == jbuild.serving_defaults(meta)
    assert index_io.serving_defaults(meta)["beam"] == (4, 2)
    # an index saved without planes loads None, in both packages
    index_io.save_index(str(tmp_path / "bare"), pidx, n_sections=10, cutoff=50.0)
    assert index_io.load_planes(str(tmp_path / "bare"), pidx) is None
    assert jbuild.load_planes(str(tmp_path / "bare"), jidx) is None


# --------------------------------------------------------- 8. the CLIs


def test_depth3_beam_cli(tmp_path, capsys):
    out = tmp_path / "idx"
    pbuild.main(["--n-proteins", "500", "--n-families", "20", "--arities", "4,4,4",
                 "--beam", "4", "--node-eval", "segmented", "--prebuilt-planes",
                 "--device", "cpu", "--out", str(out)])
    assert "prebuilt planes" in capsys.readouterr().out
    answers = pserve.main(["--index", str(out), "--n-queries", "12", "--batch", "8",
                           "--k", "5", "--stop", "0.05", "--device", "cpu", "--use-kernel"])
    text = capsys.readouterr().out
    assert "beam 4, temperatures 1.0, node eval segmented, prebuilt planes" in text
    assert answers.shape == (12, 5) and (answers[:, 0] >= 0).all()
    jidx = jbuild.load_index(str(out))
    jpl = jbuild.load_planes(str(out), jidx)
    assert jidx.arities == (4, 4, 4) and jpl is not None and len(jpl.levels) == 2
    _assert_same_planes(index_io.load_planes(str(out), to_port(jidx)), jpl)
    meta = index_io.load_meta(str(out))
    assert meta["beam_width"] == 4 and meta["node_eval"] == "segmented"
    # serving temperatures other than the planes' refold them, with a notice
    pserve.main(["--index", str(out), "--n-queries", "8", "--batch", "8", "--k", "5",
                 "--stop", "0.05", "--device", "cpu", "--temperatures", "1,0.8,0.7",
                 "--beam", "3,2"])
    text = capsys.readouterr().out
    assert "refolding" in text and "beam 3,2, temperatures 1,0.8,0.7" in text
    with pytest.raises(NotImplementedError, match="calibration"):
        pbuild.main(["--n-proteins", "100", "--calibrate", "--device", "cpu",
                     "--out", str(tmp_path / "cal")])


# ------------------------------------ 9. serve follows the meta's defaults


@pytest.mark.parametrize("meta_key", ["temperatures", "beam_width"])
def test_serve_follows_meta_defaults_like_jax(tmp_path, monkeypatch, meta_key):
    """A JAX-built index whose meta records temperatures (exact ranking)
    or a beam: the port's serve answers as JAX's ``serve --serving
    serial`` does, modulo distance ties."""
    jidx = random_jax_index(9, "kmeans", (8, 8), n=800, d=45)
    extra = ({"temperatures": (0.2, 3.0)} if meta_key == "temperatures"
             else {"beam_width": 1})
    jbuild.save_index(str(tmp_path), jidx, n_sections=10, cutoff=50.0, **extra)
    argv = ["--index", str(tmp_path), "--n-queries", "24", "--batch", "8", "--k", "10",
            "--stop", "0.02"]
    jids, jd = jax_serve_answers(monkeypatch, argv + ["--serving", "serial"])
    pids = pserve.main(argv + ["--device", "cpu"])
    # the port's serve prints distances nowhere: recompute them from its ids
    rng = np.random.default_rng(1)
    emb = np.asarray(jidx.sorted_embeddings)
    rows = emb[rng.integers(0, jidx.n_objects, 24)]
    q = np.clip(rows + rng.normal(scale=0.01, size=rows.shape).astype(np.float32), 0, 1)
    by_id = np.empty_like(emb)
    by_id[np.asarray(jidx.sorted_ids)] = emb
    pd = np.where(pids >= 0, np.linalg.norm(by_id[np.maximum(pids, 0)] - q[:, None], axis=-1),
                  np.inf)
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=E2E_ATOL).all()
