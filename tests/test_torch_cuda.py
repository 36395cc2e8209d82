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

from repro_torch.core import filtering, lmi, planes as planes_lib, store as store_lib
from repro_torch.kernels.beam_eval import ops as be_ops, ref as be_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.kmeans_assign import ops as ka_ops, ref as ka_ref
from repro_torch.kernels.lmi_filter import ops as lf_ops, ref as lf_ref
from repro_torch.kernels.pairwise_l2 import ops as pw_ops, ref as pw_ref

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
    return q.to(dev), emb.to(dev), rows.to(dev), valid.to(dev), runs, offsets.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
def test_filter_kernels_match_plain(dev, metric, dtype):
    q, emb, rows, valid, runs, _off = _runs_case(dev, seed=13)
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
    q, emb, rows, valid, runs, _off = _runs_case(dev, seed=3)
    before = dict(lf_ops.LAUNCHES)
    lf_ops.lmi_filter_topk(q, rows, valid, emb, 5, runs=runs)
    lf_ops.lmi_filter_range(q, rows, valid, emb, runs=runs)
    lf_ops.lmi_filter_topk(q, rows, valid, emb, 5)  # no runs: the row gather
    assert lf_ops.LAUNCHES["lmi_filter_topk_desc"] == before["lmi_filter_topk_desc"] + 1
    assert lf_ops.LAUNCHES["lmi_filter_range_desc"] == before["lmi_filter_range_desc"] + 1
    assert lf_ops.LAUNCHES["lmi_filter_topk_rows"] == before["lmi_filter_topk_rows"] + 1
    with pytest.raises(TypeError, match="takes"):
        lf_ops.lmi_filter_topk(q, rows, valid, emb.to(torch.float16), 5, runs=runs)
    with pytest.raises(ValueError):
        lf_ops.lmi_filter_range(q.cpu(), rows, valid, emb, runs=runs)


# (store dtype, scale granularity, compute dtype): every store tier
TIERS = [("float32", "row", "float32"), ("bfloat16", "row", "float32"),
         ("int8", "row", "float32"), ("int8", "row", "int8"), ("int8", "bucket", "float32"),
         ("int8", "bucket", "int8"), ("float8_e4m3fn", "row", "float32"),
         ("float8_e4m3fn", "bucket", "float32")]
# the integer domain: the same exact integer dot on both sides, and an
# epilogue whose float steps are rounded in the same order
INT_TOL = 2e-5


def _plain(q, rows, valid, st, compute, metric):
    if compute == "int8":
        return lf_ref.lmi_filter_int_ref(q, rows, valid, st.data, store_lib.row_scales(st),
                                         st.norms, metric=metric)
    return lf_ref.lmi_filter_ref(q, rows, valid, st.data, metric=metric,
                                 scales=store_lib.row_scales(st))


@pytest.mark.parametrize("form", ["desc", "rows"])
@pytest.mark.parametrize("tier", TIERS, ids="-".join)
@pytest.mark.parametrize("metric", METRICS)
def test_filter_kernel_tiers_match_plain(dev, metric, tier, form):
    """Every store tier, both gather forms (descriptors with the search's
    runs; the (Q, C) rows without them), against the plain version on the
    same card, through the filtering entry points."""
    dtype, gran, compute = tier
    q, emb, rows, valid, runs, offsets = _runs_case(dev, seed=17)
    emb = emb * torch.linspace(0.1, 10, emb.shape[0], device=dev)[:, None]  # scales differ
    st = store_lib.make_store(emb, torch.arange(emb.shape[0], device=dev), offsets, dtype,
                              scale_granularity=gran)
    r = runs if form == "desc" else None
    tol = INT_TOL if compute == "int8" else TOL[metric]
    want = _plain(q, rows, valid, st, compute, metric)
    got = filtering.filter_range(st, q, rows, valid, metric=metric, runs=r, compute_dtype=compute)
    fin = want < 1e37
    assert torch.equal(got < 1e37, fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=tol, atol=tol)
    kd, ki = filtering.filter_topk(st, q, rows, valid, 70, metric=metric, runs=r,
                                   compute_dtype=compute)
    rd, ri = torch.sort(want, dim=1, stable=True)
    rd, ri = rd[:, :70], ri[:, :70].int()
    fin = rd < 1e37
    assert bool((~fin).any()), "the case must exhaust some top-70 slots"
    torch.testing.assert_close(kd[fin], rd[fin], rtol=tol, atol=tol)
    assert torch.equal(ki[fin], ri[fin])  # random data: no near ties
    assert bool((ki[~fin] == -1).all()) and bool((kd[~fin] >= 1e37).all())


def test_filter_tier_launch_counts(dev):
    """Each tier counts under its own key: an int8 request over an fp8
    store resolves to float32 compute and is counted so."""
    q, emb, rows, valid, runs, offsets = _runs_case(dev, seed=5)
    ids = torch.arange(emb.shape[0], device=dev)
    i8 = store_lib.make_store(emb, ids, offsets, "int8", scale_granularity="bucket")
    f8 = store_lib.make_store(emb, ids, offsets, "float8_e4m3fn", scale_granularity="bucket")
    before = dict(lf_ops.TIER_LAUNCHES)
    filtering.filter_topk(i8, q, rows, valid, 5, runs=runs, compute_dtype="int8")
    filtering.filter_range(i8, q, rows, valid, compute_dtype="int8")
    filtering.filter_topk(f8, q, rows, valid, 5, runs=runs, compute_dtype="int8")
    filtering.filter_topk(f8, q, rows, valid, 5)
    after = lf_ops.TIER_LAUNCHES
    for key in ("lmi_filter_topk_desc:int8:run:int8", "lmi_filter_range_rows:int8:row:int8",
                "lmi_filter_topk_desc:float8_e4m3fn:run:float32",
                "lmi_filter_topk_rows:float8_e4m3fn:row:float32"):
        assert after.get(key, 0) == before.get(key, 0) + 1, key


def test_filter_kernel_checks_quant_operands(dev):
    q, emb, rows, valid, runs, offsets = _runs_case(dev, seed=4)
    st = store_lib.make_store(emb, torch.arange(emb.shape[0], device=dev), offsets, "int8")
    qi, qs = lf_ops._quantize_queries(q)
    with pytest.raises(ValueError, match="norms"):
        lf_ops.launch(qi, st.data, valid, rows=rows, scales=st.scales, scale_mode="row",
                      qscale=qs)
    with pytest.raises(TypeError, match="scales"):
        lf_ops.launch(q, st.data, valid, rows=rows, scales=st.scales.double(), scale_mode="row")
    with pytest.raises(ValueError, match="scales"):
        lf_ops.launch(q, st.data, valid, rows=rows, scales=st.scales[:-1], scale_mode="row")
    with pytest.raises(ValueError, match="does not fit"):
        lf_ops.launch(q, st.data, valid, rows=rows)
    with pytest.raises(ValueError, match="descriptor"):
        lf_ops.launch(q, st.data, valid, rows=rows, scales=st.scales, scale_mode="run")
    with pytest.raises(ValueError, match="norms"):
        lf_ops.launch(qi, st.data, valid, rows=rows, scales=st.scales, scale_mode="row",
                      qscale=qs, norms=st.norms.cpu())
    with pytest.raises(TypeError, match="rows"):
        lf_ops.launch(q, st.data, valid, rows=rows.long(), scales=st.scales, scale_mode="row")


@pytest.mark.parametrize("gran", ["row", "bucket"])
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_card_codes_equal_cpu(dev, dtype, gran):
    """Quantized on the card, the codes, scales and norms equal the CPU's
    byte for byte (the same ops, round half to even)."""
    rng = np.random.default_rng(8)
    emb = torch.from_numpy((rng.normal(size=(3000, 45)) * rng.uniform(0.01, 30, (3000, 1)))
                           .astype(np.float32))
    emb[7, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    emb[8, :5] = torch.tensor([448.0, 1.0625, 1.1875, 2.0 ** -9 * 1.5, 2.0 ** -10])
    offsets = torch.tensor([0, 0, 900, 900, 2500, 3000, 3000], dtype=torch.int32)
    cpu = store_lib.quantize(emb, dtype, gran, offsets)
    card = store_lib.quantize(emb.to(dev), dtype, gran, offsets.to(dev))
    assert torch.equal(card[0].cpu().view(torch.uint8), cpu[0].view(torch.uint8))
    assert torch.equal(card[1].cpu().view(torch.int32), cpu[1].view(torch.int32))
    assert (card[2] is None) == (cpu[2] is None)
    if cpu[2] is not None:
        assert torch.equal(card[2].cpu(), cpu[2])


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


def _random_planes(rng, family, n, a, d, dev, temperature=1.0):
    if family == "kmeans":
        params = {"centroids": rng.uniform(0, 1, (n, a, d))}
    elif family == "gmm":
        params = {"means": rng.uniform(0, 1, (n, a, d)),
                  "variances": rng.uniform(0.2, 1.0, (n, a, d)),
                  "log_weights": np.log(rng.dirichlet(np.ones(a), n))}
    else:
        params = {"w": rng.normal(size=(n, d, a)), "b": rng.normal(size=(n, a))}
    params = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in params.items()}
    return be_ops.family_planes(family, params, temperature=temperature)


# (n nodes, arity, d, queries, frontier): ragged P with long shared runs;
# the depth-3 serving shape; arity 256 at d 190, where gmm's two blocks
# do not fit in shared memory and are taken in chunks
BEAM_SHAPES = [(23, 5, 13, 6, 9), (4096, 64, 45, 512, 64), (40, 256, 190, 16, 12)]


@pytest.mark.parametrize("shape", BEAM_SHAPES)
@pytest.mark.parametrize("family", ["kmeans", "gmm", "kmeans+logreg"])
def test_beam_eval_kernel_matches_plain(dev, family, shape):
    n, a, d, nq, f = shape
    rng = np.random.default_rng(n + a)
    for temperature in (1.0, 0.7):
        planes = _random_planes(rng, family, n, a, d, dev, temperature)
        q = torch.from_numpy(rng.uniform(0, 1, (nq, d)).astype(np.float32)).to(dev)
        prefix = torch.from_numpy(rng.integers(0, n, (nq, f))).to(dev)
        prefix[:, : f // 2] = prefix[0, 0]  # a long shared run
        got = be_ops.node_scores(q, prefix, planes, family, temperature=temperature)
        torch.cuda.synchronize()
        qs = q * (temperature ** -0.5) if family == "kmeans" and temperature != 1.0 else q
        want = be_ref.node_scores_ref(qs, prefix, planes, family)
        assert got.shape == (nq, f, a)
        # float32 sums over d in another order, and |q|^2 + |c|^2 - 2 q.c
        # cancels with |q|^2 ~ d / 3: the rounding grows with d
        atol = 1e-4 if d <= 64 else 5e-4
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_beam_eval_counts_launches_and_checks_operands(dev):
    rng = np.random.default_rng(0)
    planes = _random_planes(rng, "kmeans", 8, 4, 6, dev)
    q = torch.rand((3, 6), device=dev)
    prefix = torch.randint(0, 8, (3, 2), device=dev)
    before = be_ops.LAUNCHES["beam_eval"]
    be_ops.node_scores(q, prefix, planes, "kmeans")
    assert be_ops.LAUNCHES["beam_eval"] == before + 1
    with pytest.raises(ValueError, match="arity"):
        big = be_ops.Planes(mats=(torch.zeros((2, be_ops.MAX_ARITY + 1, 6), device=dev),),
                            vecs=(torch.zeros((2, be_ops.MAX_ARITY + 1), device=dev),))
        be_ops.node_scores(q, prefix, big, "kmeans")
    with pytest.raises(ValueError, match="matrices"):
        be_ops.node_scores(q, prefix, planes, "gmm")
    with pytest.raises(ValueError):
        be_ops.node_scores(q, prefix.cpu(), planes, "kmeans")


def test_segmented_beam_on_card_matches_cpu(dev):
    """A depth-3 index built on the card answers a segmented beam with
    prebuilt planes like the same index on the CPU, modulo ties."""
    rng = np.random.default_rng(2)
    centers = rng.uniform(0, 1, (16, 45))
    x = centers[rng.integers(0, 16, 4000)] + rng.normal(scale=0.05, size=(4000, 45))
    x = torch.from_numpy(x.astype(np.float32))
    index = lmi.build(0, x.to(dev), arities=(8, 8, 8), device=dev)
    q = x[:64] + 0.01
    kw = dict(k=10, stop_condition=0.05, beam_width=(6, 3), node_eval="segmented",
              temperatures=(1.0, 0.8, 0.7))
    before = be_ops.LAUNCHES["beam_eval"]
    ids, d = filtering.knn_query(index, q.to(dev), planes=planes_lib.from_lmi(
        index, kw["temperatures"]), **kw)
    assert be_ops.LAUNCHES["beam_eval"] == before + 2  # both levels below the root prune
    cpu = index.to("cpu")
    cids, cd = filtering.knn_query(cpu, q, **kw)
    assert filtering.knn_agree(ids.cpu(), d.cpu(), cids, cd, atol=2e-3).mean() >= 0.95


# ---------------------------------------------------------- flash_attention
# (B, Hq, Hkv, T, S, dh, causal, q_offset, kv_len); None = the TPU kernel's
# own (S - T, S). Ragged T and S throughout: the kernel masks its edges.
FLASH_CASES = [
    (2, 4, 4, 200, 200, 64, True, None, None),  # MHA, cache-free forward
    (1, 8, 2, 130, 300, 128, True, None, None),  # GQA 4:1, queries at the end
    (2, 4, 4, 100, 160, 64, True, 0, 100),  # prefill into a longer cache
    (3, 8, 2, 1, 160, 128, False, 76, 77),  # a decode step
    (1, 4, 2, 5, 96, 64, False, 40, 45),  # a short block (T <= 16)
    (2, 4, 4, 1, 3000, 64, False, 2000, 2001),  # decode over a long cache: 32 kv splits
    (1, 8, 2, 12, 1000, 128, True, 900, 1000),  # a causal short block, split
    (1, 2, 2, 64, 96, 96, False, None, None),  # non-causal, dh zero-padded to 128
    (1, 4, 4, 2048, 2048, 64, True, None, None),  # causal prefill over long rows
    (2, 12, 1, 1, 4160, 128, False, 4000, 4001),  # starcoder2's 48 / 4 group as 12 / 1, decode
    (1, 4, 2, 200, 300, 64, True, 37, 237),  # the diagonal falls mid-tile (q_offset 37)
    (2, 4, 4, 50, 90, 64, True, None, None, "unaligned"),  # q rows not 16-byte aligned
]
# float32: the kernel and the plain version sum in another order (JAX's
# flash tolerance). bfloat16: both round a float32 result to bfloat16, so
# a last-bit difference before rounding can move the output by one
# bfloat16 step (2**-7 relative at worst).
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2**-7, atol=1e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_kernel_matches_plain(dev, case, dtype):
    B, Hq, Hkv, T, S, dh, causal, q_offset, kv_len, *layout = case
    rng = np.random.default_rng(T * 7 + S)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    q = randn(B, T, Hq, dh).transpose(1, 2)  # strided, as the transformer's projections
    if layout == ["unaligned"]:  # a slice of a wider tensor: every row 4 or 8 bytes off 16
        q = randn(B, T, Hq, dh + 2)[..., 2:].transpose(1, 2)
        assert q.data_ptr() % 16
    k, v = randn(B, Hkv, S, dh), randn(B, Hkv, S, dh)
    got = fa_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    assert got.shape == (B, Hq, T, dh) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_kernel_counts_launches_and_checks_operands(dev):
    q = torch.randn(1, 4, 32, 64, device=dev)
    kv = torch.randn(1, 2, 32, 64, device=dev)
    before = fa_ops.LAUNCHES["flash_attention"]
    fa_ops.flash_attention(q, kv, kv)
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dims"):
        big = torch.randn(1, 4, 32, 256, device=dev)
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="GQA"):
        fa_ops.flash_attention(q, kv[:, :1].expand(1, 3, 32, 64), kv[:, :1].expand(1, 3, 32, 64))
    with pytest.raises(ValueError, match="kv_len"):
        fa_ops.flash_attention(q, kv, kv, kv_len=33)
    with pytest.raises(ValueError, match="same device"):
        fa_ops.flash_attention(q, kv.cpu(), kv.cpu())
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1


# -------------------------------------------------------------- pairwise_l2
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m,d", [(100, 300, 45), (64, 64, 1), (513, 777, 130), (7, 1000, 33)])
def test_pairwise_l2_kernel_matches_plain(dev, n, m, d, dtype):
    rng = np.random.default_rng(n + m + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, dtype)
    y = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, dtype)
    got = pw_ops.pairwise_l2(x, y)
    # the JAX suite's bound: norm decomposition vs direct difference, float32
    # sums either way (bfloat16 inputs are exact in float32)
    torch.testing.assert_close(got, pw_ref.pairwise_l2_ref(x, y), rtol=1e-4, atol=1e-3)
    assert float(pw_ops.pairwise_l2(x, x).diagonal().abs().max()) < 1e-3
    assert bool((got >= 0).all())


def test_pairwise_l2_counts_launches(dev):
    x = torch.randn(10, 8, device=dev)
    before = pw_ops.LAUNCHES["pairwise_l2"]
    pw_ops.pairwise_l2(x, x)
    assert pw_ops.LAUNCHES["pairwise_l2"] == before + 1
    with pytest.raises(TypeError):
        pw_ops.pairwise_l2(x, x.bfloat16())


# ------------------------------------------------------------ embedding_bag
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_embedding_bag_kernel_matches_plain(dev, dtype, mode, weighted):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(1000, 72)).astype(np.float32)).to(dev, dtype)
    ids = torch.from_numpy(rng.integers(0, 1000, (37, 50)).astype(np.int32)).to(dev)
    ids[:, 1] = ids[:, 0]  # duplicate ids accumulate
    ids[0, 3] = -1  # out-of-range ids add nothing
    ids[1, 4] = 1000
    w = torch.from_numpy(rng.uniform(0.1, 2.0, (37, 50)).astype(np.float32)).to(dev) \
        if weighted else None
    got = eb_ops.embedding_bag(table, ids, w, mode=mode)
    # float32 sums of 50 rows in another order (bag order vs the plain reduction)
    torch.testing.assert_close(got, eb_ref.embedding_bag_ref(table, ids, w, mode=mode),
                               rtol=1e-5, atol=1e-5)


def test_embedding_bag_counts_launches_and_is_deterministic(dev):
    table = torch.randn(500, 64, device=dev)
    ids = torch.randint(0, 500, (2048, 50), device=dev, dtype=torch.int32)
    before = eb_ops.LAUNCHES["embedding_bag"]
    a = eb_ops.embedding_bag(table, ids)
    b = eb_ops.embedding_bag(table, ids)
    assert eb_ops.LAUNCHES["embedding_bag"] == before + 2
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bags of at most"):
        eb_ops.embedding_bag(table, torch.zeros((2, eb_ops.MAX_BAG + 1), device=dev,
                                                dtype=torch.int32))


# ------------------------------------------------------------------ the LM
def test_lm_decode_matches_forward_on_card(dev):
    """stablelm-1.6b at full width and 2 layers (float32 weights): prefill
    then teacher-forced decode steps give the cache-free forward's logits,
    every attention through the kernel."""
    import dataclasses

    from repro_torch.configs import stablelm_1_6b
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(stablelm_1_6b.make_full(), n_layers=2, dtype=torch.float32)
    model = T.init_params(0, cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)).to(dev)
    before = fa_ops.LAUNCHES["flash_attention"]
    full, _ = model(tokens)
    logits, cache = model.prefill(tokens[:, :64], max_len=96, full_logits=False)
    steps = []
    for t in range(64, 80):
        step, cache = model.decode_step(tokens[:, t:t + 1], cache)
        steps.append(step)
    assert fa_ops.LAUNCHES["flash_attention"] == before + 2 * (1 + 1 + 16)
    # the JAX suite's decode-vs-forward bound (tests/test_configs_smoke.py)
    torch.testing.assert_close(logits, full[:, 63], rtol=5e-2, atol=5e-3)
    torch.testing.assert_close(torch.stack(steps, 1), full[:, 64:80], rtol=5e-2, atol=5e-3)
