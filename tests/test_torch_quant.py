"""The port's quantized candidate stores (int8 / fp8-e4m3, row and bucket
scales, float32 and int8 compute) against the JAX package on the same
inputs: the codes, scales and norms bit for bit, the host side of the
quantized filter, the plain filter vs the JAX oracle and vs the Pallas
kernels in interpret mode (descriptor and row gathers), `knn_query` /
`range_query` end to end on a JAX-built index, and the CLIs. The CUDA
kernel runs only on a card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filtering as jfilt
from repro.core import store as jstore
from repro.kernels.lmi_filter import ops as jops, ref as jref
from repro.launch import build_index as jbuild
from repro_torch.core import filtering as pfilt
from repro_torch.core import store as pstore
from repro_torch.index_io import load_index
from repro_torch.kernels.lmi_filter import ops as pops, ref as pref
from repro_torch.launch import build_index as pbuild, serve as pserve
from torch_parity import (E2E_ATOL, TOL, jax_serve_answers, np_, perturbed_queries,
                          port_runs, runs_case, to_port)

METRICS = ("euclidean", "sq_euclidean", "cosine")
QDTYPES = ("int8", "float8_e4m3fn")
# (store dtype, scale granularity, compute dtype): every valid quantized tier
TIERS = [("int8", "row", "float32"), ("int8", "row", "int8"), ("int8", "bucket", "float32"),
         ("int8", "bucket", "int8"), ("float8_e4m3fn", "row", "float32"),
         ("float8_e4m3fn", "bucket", "float32")]
# the JAX suite's int-domain tolerance (test_store.py): both sides compute
# the same exact integer dot, so only the float epilogue rounds
INT_TOL = 2e-5


def _tid(tier):
    return "-".join(tier)


def _edge_rows(d):
    """Rows whose codes sit on rounding ties: absmax 127 (int8) and 448
    (fp8) make the scale exactly 1, so x / s is x."""
    r = np.zeros((4, d), np.float32)
    r[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # int8 half-to-even ties
    r[1, :8] = [448.0, 1.0625, 1.1875, 2.0 ** -9 * 1.5, 2.0 ** -10, -2.0 ** -11, 3.0, -0.0]
    r[2, :] = 1e-13  # below the 1e-12 absmax floor
    return r  # row 3: all zero


def _offsets(n, n_buckets, rng):
    """CSR offsets with empty buckets at the front, inside and at the end."""
    cuts = np.sort(rng.integers(0, n + 1, n_buckets - 3))
    return np.concatenate([[0, 0], cuts, [n, n]]).astype(np.int32)


def _quant_pair(emb, offsets, dtype, gran):
    j = jstore.make_store(emb, np.arange(emb.shape[0], dtype=np.int32), offsets, dtype,
                          scale_granularity=gran)
    p = pstore.make_store(torch.from_numpy(emb), torch.arange(emb.shape[0]),
                          torch.from_numpy(offsets), dtype, scale_granularity=gran)
    return j, p


def _bytes(x):
    a = np.ascontiguousarray(np_(x.view(torch.uint8)) if isinstance(x, torch.Tensor)
                             else np.asarray(x))
    return a.view(np.uint8)


# ------------------------------------------------- 1. store quantization


@pytest.mark.parametrize("gran", ["row", "bucket"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_bitwise_equal_jax(dtype, gran):
    """Codes, scales and norms of the port equal JAX's byte for byte,
    including rounding ties, fp8 subnormals, the absmax floor, all-zero
    rows and empty buckets."""
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(400, 45)).astype(np.float32) * rng.uniform(0.01, 30, (400, 1))
    emb = emb.astype(np.float32)
    emb[100:104] = _edge_rows(45)
    offsets = _offsets(400, 12, rng)
    j, p = _quant_pair(emb, offsets, dtype, gran)
    np.testing.assert_array_equal(_bytes(p.data), _bytes(j.data))
    np.testing.assert_array_equal(np_(p.scales).view(np.int32),
                                  np.asarray(j.scales).view(np.int32))
    assert p.scales.shape == ((400,) if gran == "row" else (offsets.shape[0] - 1,))
    if dtype == "int8":
        assert p.norms.dtype == torch.int32
        np.testing.assert_array_equal(np_(p.norms), np.asarray(j.norms))
    else:
        assert p.norms is None and j.norms is None
    assert p.nbytes() == j.nbytes() and p.nbytes(False) == j.nbytes(False)


@pytest.mark.parametrize("gran", ["row", "bucket"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_row_scales_and_dequantize_match_jax(dtype, gran):
    rng = np.random.default_rng(6)
    emb = rng.uniform(0, 1, (250, 45)).astype(np.float32)
    offsets = _offsets(250, 9, rng)
    j, p = _quant_pair(emb, offsets, dtype, gran)
    np.testing.assert_array_equal(np_(pstore.row_scales(p)), np.asarray(jstore.row_scales(j)))
    np.testing.assert_array_equal(np_(pstore.dequantize(p)), np.asarray(jstore.dequantize(j)))
    rows = rng.integers(0, 250, (7, 11))
    np.testing.assert_array_equal(np_(pstore.dequantize_rows(p, torch.from_numpy(rows))),
                                  np.asarray(jstore.dequantize_rows(j, jnp.asarray(rows))))
    # round trip: within half a quantization step of the group's absmax
    err = np.abs(np_(pstore.dequantize(p)) - emb).max()
    assert err <= (0.5 / 127 if dtype == "int8" else 1 / 16) * 1.0 + 1e-6


def test_bucket_granularity_needs_offsets():
    with pytest.raises(ValueError, match="offsets"):
        pstore.quantize(torch.zeros((3, 4)), "int8", "bucket")


# ------------------------------------------- 2. host side of the filter


def test_quantize_queries_bitwise_equal_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(9, 45)).astype(np.float32)
    q[0] = 0.0
    q[1, :4] = [127.0, 0.5, -1.5, 2.5]  # scale 1: half-to-even ties
    jqi, js = jops._quantize_queries(jnp.asarray(q))
    pqi, ps = pops._quantize_queries(torch.from_numpy(q))
    assert pqi.dtype == torch.int8 and tuple(ps.shape) == (9, 1)
    np.testing.assert_array_equal(np_(pqi), np.asarray(jqi))
    np.testing.assert_array_equal(np_(ps).view(np.int32), np.asarray(js).view(np.int32))


def _case(seed=0):
    """`runs_case` with the buckets at scales 0.1 to 10 apart (so bucket and
    row scales differ) and queries at 3x: -> (q, emb, offsets, rows, valid,
    runs)."""
    q, emb, offsets, rows, valid, runs = runs_case(seed)
    sizes = np.diff(offsets)
    factor = np.random.default_rng(seed).uniform(0.1, 10, sizes.shape[0]).astype(np.float32)
    return q * 3, emb * factor.repeat(sizes)[:, None], offsets, rows, valid, runs


def test_run_scales_match_jax():
    q, emb, offsets, rows, valid, runs = _case(3)
    j, p = _quant_pair(emb, offsets, "int8", "bucket")
    _n, dstart, _o, _l = jops._run_descriptors(runs, rows.shape[1])
    want = jops._run_scales(dstart, j.scales, j.offsets)
    got = pops._run_scales(torch.tensor(np.asarray(dstart)), p.scales, p.offsets)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


_PLAN_CASES = [
    # (store dtype, compute, scales?, bucket scales?, norms?, runs?)
    ("float32", "float32", False, False, False, False),
    ("bfloat16", "float32", True, False, False, True),
    ("int8", "float32", True, False, False, False),
    ("int8", "int8", True, False, True, True),
    ("int8", "int8", False, True, True, True),
    ("float8_e4m3fn", "float32", False, True, False, True),
    ("float8_e4m3fn", "float32", True, True, False, False),
    ("int8", "int4", True, False, True, False),  # unknown compute dtype
    ("float8_e4m3fn", "int8", True, False, True, False),  # int8 compute, fp8 store
    ("int8", "int8", True, False, False, False),  # no norms
    ("int8", "float32", False, True, False, False),  # bucket scales without runs
    ("float8_e4m3fn", "float32", False, False, False, True),  # no scales at all
]


@pytest.mark.parametrize("case", _PLAN_CASES)
def test_quant_plan_matches_jax(case):
    """`_quant_plan` resolves the same mode and raises where JAX raises,
    with the same message (JAX's per-row "plane" is the port's "row")."""
    dtype, compute, sc, bsc, nm, rn = case
    args = (dtype, compute, object() if sc else None, object() if bsc else None,
            object() if bsc else None, object() if nm else None, object() if rn else None)
    try:
        want = jops._quant_plan(*args[:5], norms=args[5], runs=args[6])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0][:40]):
            pops._quant_plan(*args)
        return
    mode, intdom = pops._quant_plan(*args)
    assert ({"plane": "row"}.get(want[0], want[0]), want[1]) == (mode, intdom)


# ------------------------------------------- 3. the plain quantized filter


def _tier_ops(tier, seed=7):
    """The case, both stores, and each package's quantization kwargs for
    the descriptor form (runs) and the row form."""
    dtype, gran, compute = tier
    q, emb, offsets, rows, valid, runs = _case(seed)
    j, p = _quant_pair(emb, offsets, dtype, gran)
    return q, rows, valid, runs, j, p


def _jax_want(q, rows, valid, j, compute, metric):
    if compute == "int8":
        return np.asarray(jref.lmi_filter_int_ref(q, rows, valid, j.data, jstore.row_scales(j),
                                                  j.norms, metric=metric))
    return np.asarray(jref.lmi_filter_ref(q, rows, valid, j.data, metric=metric,
                                          scales=jstore.row_scales(j)))


def _assert_range(got, want, tol):
    np.testing.assert_array_equal(got >= 1e37, want >= 1e37)
    fin = want < 1e37
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


def _assert_topk(gd, gi, wd, wi, tol, exhausted_slot=None):
    fin = wd < 1e37
    assert (~fin).any(), "the case must exhaust some top-40 slots"
    np.testing.assert_array_equal(gd >= 1e37, ~fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=tol, atol=tol)
    np.testing.assert_array_equal(gi[fin], wi[fin])  # random data: no near ties
    if exhausted_slot is not None:
        assert (wi[~fin] == exhausted_slot).all()


@pytest.mark.parametrize("tier", TIERS, ids=_tid)
@pytest.mark.parametrize("metric", METRICS)
def test_plain_filter_matches_jax_ref(metric, tier):
    """The port's filter entry points on the CPU (both gather forms' kwargs,
    as `filtering._quant_kwargs` builds them) vs the JAX oracle."""
    compute = tier[2]
    q, rows, valid, runs, j, p = _tier_ops(tier)
    tol = INT_TOL if compute == "int8" else TOL[metric]
    want = _jax_want(q, rows, valid, j, compute, metric)
    args = (torch.from_numpy(q), torch.from_numpy(rows), torch.from_numpy(valid))
    for prun in (port_runs(runs), None):
        got = np_(pfilt.filter_range(p, *args, metric=metric, runs=prun, compute_dtype=compute))
        _assert_range(got, want, tol)
        gd, gi = pfilt.filter_topk(p, *args, 40, metric=metric, runs=prun,
                                   compute_dtype=compute)
        wd = np.sort(want, axis=1, kind="stable")[:, :40]
        wi = np.argsort(want, axis=1, kind="stable")[:, :40]
        _assert_topk(np_(gd), np_(gi), wd, wi, tol)
    jd, ji = jfilt.filter_topk(j, q, rows, valid, 40, metric=metric, compute_dtype=compute)
    fin = np.asarray(jd) < 1e37
    np.testing.assert_array_equal(np_(gi)[fin], np.asarray(ji)[fin])


# the Pallas kernels in interpret mode are slow to trace (the descriptor
# form ~8 s a case), so each tier is run once, metrics spread over them
_PALLAS_CASES = [
    ("rows", "topk", ("int8", "row", "float32"), "euclidean"),
    ("rows", "range", ("int8", "row", "int8"), "cosine"),
    ("rows", "topk", ("int8", "bucket", "int8"), "sq_euclidean"),
    ("rows", "range", ("float8_e4m3fn", "bucket", "float32"), "euclidean"),
    ("rows", "topk", ("float8_e4m3fn", "row", "float32"), "cosine"),
    ("desc", "topk", ("int8", "bucket", "int8"), "euclidean"),
    ("desc", "range", ("float8_e4m3fn", "bucket", "float32"), "sq_euclidean"),
    ("desc", "topk", ("int8", "row", "float32"), "cosine"),
]


@pytest.mark.parametrize("form,kernel,tier,metric", _PALLAS_CASES)
def test_plain_filter_matches_pallas_kernels(form, kernel, tier, metric):
    """The Pallas kernels the CUDA kernel replaces —
    `lmi_filter_{topk,range}_desc_pallas` (with runs; bucket scales as
    per-run scalars) and `lmi_filter_{topk,range}_pallas` (rows only) —
    in interpret mode, vs the port's filter on the same store."""
    compute = tier[2]
    q, rows, valid, runs, j, p = _tier_ops(tier, seed=11)
    tol = INT_TOL if compute == "int8" else TOL[metric]
    jruns = runs if form == "desc" else None
    jkw = jfilt._quant_kwargs(j, jruns, compute)
    prun = port_runs(runs) if form == "desc" else None
    args = (torch.from_numpy(q), torch.from_numpy(rows), torch.from_numpy(valid))
    if kernel == "range":
        want = np.asarray(jops.lmi_filter_range(q, rows, valid, j.data, metric=metric,
                                                interpret=True, runs=jruns, **jkw))
        got = np_(pfilt.filter_range(p, *args, metric=metric, runs=prun, compute_dtype=compute))
        _assert_range(got, want, tol)
        return
    wd, wi = (np.asarray(a) for a in jops.lmi_filter_topk(
        q, rows, valid, j.data, 40, metric=metric, interpret=True, runs=jruns, **jkw))
    gd, gi = pfilt.filter_topk(p, *args, 40, metric=metric, runs=prun, compute_dtype=compute)
    _assert_topk(np_(gd), np_(gi), wd, wi, tol, exhausted_slot=-1)


def test_ops_rejects_what_jax_rejects():
    q, rows, valid, runs, _j, p = _tier_ops(("int8", "row", "float32"))
    args = (torch.from_numpy(q), torch.from_numpy(rows), torch.from_numpy(valid), p.data)
    with pytest.raises(ValueError, match="norms"):
        pops.lmi_filter_range(*args, scales=p.scales, compute_dtype="int8")
    with pytest.raises(ValueError, match="per-row scales"):
        pops.lmi_filter_topk(*args, 5, bucket_scales=p.scales, offsets=p.offsets)
    with pytest.raises(ValueError, match="compute_dtype"):
        pops.lmi_filter_range(*args, scales=p.scales, compute_dtype="int4")


# --------------------------------------------- 4. queries end to end


@pytest.fixture(scope="module")
def e2e(small_lmi):
    pidx = to_port(small_lmi)
    q = perturbed_queries(small_lmi.sorted_embeddings, 24)
    jids, _ = jfilt.knn_query(small_lmi, q, k=10, stop_condition=0.05)
    pids, _ = pfilt.knn_query(pidx, torch.from_numpy(q), k=10, stop_condition=0.05)
    return pidx, q, np.asarray(jids), np_(pids)


def _recall(got, ref):
    return np.mean([len(np.intersect1d(g[g >= 0], r[r >= 0])) / max((r >= 0).sum(), 1)
                    for g, r in zip(got, ref)])


@pytest.mark.parametrize("tier", TIERS, ids=_tid)
def test_knn_query_quantized_matches_jax(small_lmi, e2e, tier):
    """Quantized kNN on a JAX-built index (empty buckets included) answers
    as JAX's modulo ties, and its recall@10 against each package's own f32
    answers is JAX's."""
    pidx, q, jf32, pf32 = e2e
    dtype, gran, compute = tier
    jst = jstore.from_lmi(small_lmi, dtype, scale_granularity=gran)
    pst = pstore.from_lmi(pidx, dtype, scale_granularity=gran)
    jids, jd = jfilt.knn_query(small_lmi, q, k=10, stop_condition=0.05, store=jst,
                               compute_dtype=compute)
    pids, pd = pfilt.knn_query(pidx, torch.from_numpy(q), k=10, stop_condition=0.05,
                               store=pst, compute_dtype=compute)
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=E2E_ATOL).all()
    assert _recall(np_(pids), pf32) == _recall(np.asarray(jids), jf32)


@pytest.mark.parametrize("tier", [("int8", "bucket", "int8"), ("float8_e4m3fn", "row", "float32")],
                         ids=_tid)
def test_range_query_quantized_matches_jax(small_lmi, e2e, tier):
    pidx, q, _jf, _pf = e2e
    dtype, gran, compute = tier
    jst = jstore.from_lmi(small_lmi, dtype, scale_granularity=gran)
    pst = pstore.from_lmi(pidx, dtype, scale_granularity=gran)
    jr = jfilt.range_query(small_lmi, q, 0.2, stop_condition=0.05, radius_scale=1.5, store=jst,
                           compute_dtype=compute)
    pr = pfilt.range_query(pidx, torch.from_numpy(q), 0.2, stop_condition=0.05, radius_scale=1.5,
                           store=pst, compute_dtype=compute)
    jd, pd = np.asarray(jr.distances), np_(pr.distances)
    np.testing.assert_array_equal(pd >= 1e37, jd >= 1e37)
    fin = jd < 1e37
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=0, atol=E2E_ATOL)
    near = np.abs(jd - 0.3) <= E2E_ATOL
    np.testing.assert_array_equal(np_(pr.mask) | near, np.asarray(jr.mask) | near)
    assert np_(pr.mask).any()


def test_effective_compute_matches_jax(small_lmi, e2e):
    """fp8 / bf16 stores and an int8 store without norms run float32 for
    an int8 request, as in JAX; with norms the int8 store runs int8."""
    pidx = e2e[0]
    for dtype in ("bfloat16", "float8_e4m3fn", "int8"):
        for strip in (False, True):
            jst = jstore.from_lmi(small_lmi, dtype)
            pst = pstore.from_lmi(pidx, dtype)
            if strip:
                jst, pst = (dataclasses.replace(s, norms=None) for s in (jst, pst))
            for compute in ("float32", "int8"):
                assert (pfilt._effective_compute(pst, compute)
                        == jfilt._effective_compute(jst, compute))
    assert pfilt._effective_compute(pstore.from_lmi(pidx, "float8_e4m3fn"), "int8") == "float32"
    assert pfilt._effective_compute(pstore.from_lmi(pidx, "int8"), "int8") == "int8"


def test_store_api_quantized(small_lmi, e2e):
    pidx = e2e[0]
    st = pstore.from_lmi(pidx, "int8", scale_granularity="bucket")
    assert st.data.dtype == torch.int8 and st.scale_granularity == "bucket"
    assert st.scales.shape == (pidx.n_leaves,) and st.norms.shape == (pidx.n_objects,)
    assert st.nbytes(False) == pidx.n_objects * (pidx.dim + 4) + pidx.n_leaves * 4
    again = pstore.refresh(pidx, st)
    assert (again.dtype, again.scale_granularity) == ("int8", "bucket")
    assert torch.equal(again.data, st.data)


# ------------------------------------------------------------- 5. the CLIs


def test_serve_cli_serves_a_jax_quantized_index_like_jax(tmp_path, monkeypatch, capsys):
    """JAX's build_index --store-dtype int8 --scale-granularity bucket
    --compute-dtype int8, then the port's serve from the meta: JAX's
    banner and JAX's answers, modulo ties."""
    out = tmp_path / "jax_index"
    monkeypatch.setattr(sys, "argv", [
        "build_index", "--n-proteins", "400", "--n-families", "10", "--arity", "4", "4",
        "--store-dtype", "int8", "--scale-granularity", "bucket", "--compute-dtype", "int8",
        "--out", str(out)])
    jbuild.main()
    argv = ["--index", str(out), "--n-queries", "16", "--batch", "8", "--k", "5",
            "--stop", "0.1"]
    jids, jd = jax_serve_answers(monkeypatch, argv + ["--serving", "serial"])
    jtext = capsys.readouterr().out
    pids = pserve.main(argv + ["--device", "cpu"])
    ptext = capsys.readouterr().out
    banner = "store dtype int8 (bucket scales, int8 compute)"
    assert banner in jtext and banner in ptext
    # the port's serve prints no distances: recompute its answers' int-domain
    # distances from the same store, query by query
    pidx = load_index(str(out), device="cpu")
    st = pstore.from_lmi(pidx, "int8", scale_granularity="bucket")
    rng = np.random.default_rng(1)
    emb = np_(pidx.sorted_embeddings)
    rows = emb[rng.integers(0, pidx.n_objects, 16)]
    q = np.clip(rows + rng.normal(scale=0.01, size=rows.shape).astype(np.float32), 0, 1)
    row_of = np.empty(pidx.n_objects, np.int64)
    row_of[np_(pidx.sorted_ids)] = np.arange(pidx.n_objects)
    prow = torch.from_numpy(row_of[np.maximum(pids, 0)])
    pd = np_(pref.lmi_filter_int_ref(torch.from_numpy(q), prow, torch.from_numpy(pids >= 0),
                                     st.data, pstore.row_scales(st), st.norms))
    pd = np.where(pids >= 0, pd, np.inf)
    assert pfilt.knn_agree(pids, pd, jids, jd, atol=E2E_ATOL).all()


def test_build_cli_writes_the_quant_meta_keys_like_jax(tmp_path, capsys):
    tiny = ["--n-proteins", "300", "--n-families", "10", "--arity", "4", "4", "--device", "cpu"]
    out = tmp_path / "q"
    pbuild.main(tiny + ["--store-dtype", "int8", "--scale-granularity", "bucket",
                        "--compute-dtype", "int8", "--out", str(out)])
    assert "candidate store (int8, bucket scales)" in capsys.readouterr().out
    meta = json.loads((out / "meta.json").read_text())
    jidx = jbuild.load_index(str(out))
    jbuild.save_index(str(tmp_path / "j"), jidx, n_sections=10, cutoff=50.0,
                      store_dtype="int8", scale_granularity="bucket", compute_dtype="int8")
    jmeta = json.loads((tmp_path / "j" / "meta.json").read_text())
    for key in ("store_dtype", "scale_granularity", "compute_dtype"):
        assert meta[key] == jmeta[key]
    assert jbuild.serving_defaults(meta)["compute_dtype"] == "int8"
    # defaults stay out of the meta, as in JAX
    pbuild.main(tiny + ["--out", str(tmp_path / "d")])
    dmeta = json.loads((tmp_path / "d" / "meta.json").read_text())
    assert "scale_granularity" not in dmeta and "compute_dtype" not in dmeta
    with pytest.raises(ValueError, match="granularity"):
        pbuild.main(tiny + ["--scale-granularity", "tile", "--out", str(tmp_path / "x")])


def test_serve_banner_names_the_resolved_compute(tmp_path, capsys):
    """int8 compute over an fp8 store runs float32, and the banner says so."""
    out = tmp_path / "idx"
    pbuild.main(["--n-proteins", "300", "--n-families", "10", "--arity", "4", "4",
                 "--device", "cpu", "--out", str(out)])
    capsys.readouterr()
    answers = pserve.main(["--index", str(out), "--n-queries", "8", "--batch", "8", "--k", "5",
                           "--stop", "0.1", "--device", "cpu", "--store-dtype", "float8_e4m3fn",
                           "--scale-granularity", "bucket", "--compute-dtype", "int8"])
    text = capsys.readouterr().out
    assert answers.shape == (8, 5) and (answers[:, 0] >= 0).all()
    assert "store dtype float8_e4m3fn (bucket scales, float32 compute; int8 asked for" in text
