"""The port's LM serving path (``repro_torch.models``) against the JAX
package on the CPU: the layers, the plain version of the flash kernel
against JAX's Pallas kernel in interpret mode, the cache-free forward
against JAX's ``attn_impl="pallas"``, and prefill + decode against JAX's
``"chunked"``. Inputs come from numpy with a seed; JAX's parameters cross
to the port through ``params_from_jax``.

Tolerances:

* float32: the JAX suite's own 2e-4 (``tests/test_kernels.py`` flash
  attention): the two frameworks sum the same float32 products in
  another order.
* bfloat16 layers: both round the same float32 result to bfloat16, so a
  last-bit difference before rounding moves an output by one bfloat16
  step (2**-7 relative at worst).
* bfloat16 model: every matrix product rounds its output to bfloat16;
  XLA and PyTorch accumulate the float32 sums in another order, so single
  activations differ by a bfloat16 step and the difference travels
  through the layers. The logits are compared at 1/32 of their largest
  magnitude (about four bfloat16 steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stablelm_1_6b as j_stablelm, starcoder2_15b as j_starcoder
from repro.data import pipeline as jpipeline
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import layers as JL, transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.configs import stablelm_1_6b as p_stablelm, starcoder2_15b as p_starcoder
from repro_torch.data import pipeline as ppipeline
from repro_torch.kernels.flash_attention import ops as pfa_ops
from repro_torch.models import layers as PL, transformer as PT

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2**-7, atol=1e-3)
KEY = jax.random.PRNGKey(0)
ARCHS = {"stablelm": (j_stablelm, p_stablelm), "starcoder2": (j_starcoder, p_starcoder)}
DTYPES = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().copy()  # the caches change in place
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(rng, *shape, dtype="f32"):
    """The same normal numbers as a JAX array and a tensor of one type."""
    a = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jx, px = _pair(rng, 3, 5, 64, dtype=dtype)
    jg, pg = _pair(rng, 64, dtype=dtype)
    got = PL.rms_norm(px, pg)
    assert got.dtype == px.dtype
    _close(got, JL.rms_norm(jx, jg), F32 if dtype == "f32" else BF16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_matches_jax(dtype, batched_positions):
    """RoPE rotates the two halves of the head dim with float32 angles."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 5000, (2, 9) if batched_positions else (9,)).astype(np.int32)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 64, 1e4)
    pcos, psin = PL.rope_angles(torch.from_numpy(pos), 64, 1e4)
    assert pcos.dtype == torch.float32
    _close(pcos, jcos, F32)
    _close(psin, jsin, F32)
    jx, px = _pair(rng, 2, 3, 9, 64, dtype=dtype)
    got = PL.apply_rope(px, pcos, psin)
    assert got.dtype == px.dtype
    _close(got, JL.apply_rope(jx, jcos, jsin), F32 if dtype == "f32" else BF16)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 7), (False, 0)])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_full_attention_matches_jax(heads, causal, q_offset):
    hq, hkv = heads
    rng = np.random.default_rng(2)
    jq, pq = _pair(rng, 2, hq, 9, 32)
    jk, pk = _pair(rng, 2, hkv, 16, 32)
    jv, pv = _pair(rng, 2, hkv, 16, 32)
    got = PL.full_attention(pq, pk, pv, causal=causal, q_offset=q_offset)
    _close(got, JL.full_attention(jq, jk, jv, causal=causal, q_offset=q_offset), F32)


# (Hq, Hkv, T, S, chunk, causal, q_offset, valid prefix of the kv mask)
CHUNKED = [
    (4, 4, 32, 32, 8, True, 0, None),
    (8, 2, 32, 64, 16, True, 32, None),
    (4, 4, 32, 64, 16, True, 0, 32),  # prefill into a longer cache
    (8, 2, 16, 64, 16, False, 20, 37),  # a masked block (decode-like)
]


@pytest.mark.parametrize("case", CHUNKED, ids=lambda c: "x".join(map(str, c)))
def test_chunked_attention_matches_jax(case):
    hq, hkv, t, s, chunk, causal, q_offset, valid = case
    rng = np.random.default_rng(3)
    jq, pq = _pair(rng, 2, hq, t, 32)
    jk, pk = _pair(rng, 2, hkv, s, 32)
    jv, pv = _pair(rng, 2, hkv, s, 32)
    jm = pm = None
    if valid is not None:
        jm = jnp.broadcast_to(jnp.arange(s) < valid, (2, s))
        pm = PL.prefix_mask(2, s, valid, "cpu")
    want = JL.chunked_attention(jq, jk, jv, causal=causal, q_offset=q_offset, q_chunk=chunk,
                                kv_chunk=chunk, kv_mask=jm)
    got = PL.chunked_attention(pq, pk, pv, causal=causal, q_offset=q_offset, q_chunk=chunk,
                               kv_chunk=chunk, kv_mask=pm)
    _close(got, want, F32)
    if valid is not None:  # the kernel's form of the same call
        flash = pfa_ops.flash_attention(pq, pk, pv, causal=causal, q_offset=q_offset,
                                        kv_len=valid)
        _close(flash, want, F32)


def test_chunked_attention_takes_a_short_last_chunk():
    """Chunks that do not divide T and S (JAX asserts they do) give the
    same result as dividing chunks."""
    rng = np.random.default_rng(4)
    _, q = _pair(rng, 1, 4, 40, 32)
    _, k = _pair(rng, 1, 4, 70, 32)
    _, v = _pair(rng, 1, 4, 70, 32)
    mask = PL.prefix_mask(1, 70, 40, "cpu")
    a = PL.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=16, kv_mask=mask)
    b = PL.chunked_attention(q, k, v, causal=True, q_chunk=40, kv_chunk=70, kv_mask=mask)
    _close(a, b, F32)


@pytest.mark.parametrize("t,s,impl,kv_len,ran", [
    (32, 32, "auto", None, "full_attention"),
    (32, 64, "auto", 32, "chunked_attention"),
    (32, 64, "chunked", 32, "chunked_attention"),
    (4, 64, "chunked", 20, "_masked_softmax_attention"),
    (4, 64, "chunked", None, "full_attention"),
    (32, 32, "pallas", None, "flash_attention"),
])
def test_attention_dispatch_follows_jax_rules(monkeypatch, t, s, impl, kv_len, ran):
    """On a CPU tensor the dispatcher resolves impl by JAX's rules
    ("auto" by size and mask, T <= 16 to the masked full path) and runs the
    plain code; the answer equals JAX's ``attention`` with the same mask."""
    called = []
    for name in ("full_attention", "chunked_attention", "_masked_softmax_attention"):
        fn = getattr(PL, name)
        monkeypatch.setattr(PL, name, lambda *a, _f=fn, _n=name, **k: called.append(_n) or _f(*a, **k))
    fn = pfa_ops.flash_attention
    monkeypatch.setattr(pfa_ops, "flash_attention",
                        lambda *a, **k: called.append("flash_attention") or fn(*a, **k))
    rng = np.random.default_rng(5)
    jq, pq = _pair(rng, 2, 4, t, 32)
    jk, pk = _pair(rng, 2, 4, s, 32)
    jv, pv = _pair(rng, 2, 4, s, 32)
    got = PL.attention(pq, pk, pv, causal=t > 1, q_offset=0, kv_len=kv_len, impl=impl, chunk=16)
    assert called[0] == ran  # full_attention runs the masked form inside
    jmask = None if kv_len is None else jnp.broadcast_to(jnp.arange(s) < kv_len, (2, s))
    jimpl = "chunked" if impl == "pallas" else impl
    want = JL.attention(jq, jk, jv, causal=t > 1, q_offset=0, kv_mask=jmask, impl=jimpl, chunk=16)
    _close(got, want, F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlps_match_jax(dtype):
    """SwiGLU, and starcoder2's GELU MLP with jax.nn.gelu's tanh form, with
    weights at the model's scale (fan-in**-0.5). bfloat16 rounds three
    products and the gate: compared at 2**-6 of the largest output."""
    rng = np.random.default_rng(6)
    jx, px = _pair(rng, 2, 5, 32, dtype=dtype)
    ws = []
    for shape in ((32, 48), (32, 48), (48, 32)):
        a = (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
        ws.append((jnp.asarray(a).astype(DTYPES[dtype][0]), torch.from_numpy(a).to(DTYPES[dtype][1])))
    (jw1, pw1), (jw3, pw3), (jw2, pw2) = ws
    for got, want in ((PL.swiglu(px, pw1, pw3, pw2), JL.swiglu(jx, jw1, jw3, jw2)),
                      (PL.gelu_mlp(px, pw1, pw2), jax.nn.gelu(jx @ jw1) @ jw2)):
        tol = F32 if dtype == "f32" else dict(rtol=0, atol=np.abs(_np(want)).max() * 2**-6)
        _close(got, want, tol)


# ------------------------------------------------------- flash, plain form
# (B, Hq, Hkv, T, S, causal): T and S 128-aligned, as JAX's wrapper demands
FLASH = [
    (1, 4, 4, 128, 128, True),
    (2, 8, 2, 128, 128, True),
    (1, 4, 4, 128, 256, True),  # S > T: queries at the end of the stream
    (1, 8, 2, 128, 256, False),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH, ids=lambda c: "x".join(map(str, c)))
def test_flash_plain_matches_jax_pallas(case, dtype):
    """The kernel's plain version against JAX's Pallas kernel (interpret
    mode) with the TPU kernel's defaults: q_offset S - T, kv_len S."""
    b, hq, hkv, t, s, causal = case
    rng = np.random.default_rng(7)
    jq, pq = _pair(rng, b, hq, t, 64, dtype=dtype)
    jk, pk = _pair(rng, b, hkv, s, 64, dtype=dtype)
    jv, pv = _pair(rng, b, hkv, s, 64, dtype=dtype)
    want = jfa_ops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    got = pfa_ops.flash_attention(pq, pk, pv, causal=causal)
    assert got.dtype == pq.dtype and got.shape == pq.shape
    _close(got, want, F32 if dtype == "f32" else BF16)


# ------------------------------------------------------------------ model
def _configs(arch: str, jax_impl: str, port_impl: str, dtype: str = "f32"):
    jmod, pmod = ARCHS[arch]
    jcfg = dataclasses.replace(jmod.make_smoke(), attn_impl=jax_impl, dtype=DTYPES[dtype][0])
    pcfg = dataclasses.replace(pmod.make_smoke(), attn_impl=port_impl, dtype=DTYPES[dtype][1])
    return jcfg, pcfg


def _models(jcfg, pcfg):
    jparams = JT.init_params(KEY, jcfg)
    return jparams, PT.params_from_jax(jax.tree.map(np.asarray, jparams), pcfg, device="cpu")


def _tokens(vocab, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("port_impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax_pallas(arch, port_impl):
    """The cache-free forward at T=128 against JAX's forward through the
    Pallas flash kernel (interpret mode); the port through the kernel's
    plain version ("pallas") and through the plain chunked path."""
    jcfg, pcfg = _configs(arch, "pallas", port_impl)
    jparams, model = _models(jcfg, pcfg)
    tok = _tokens(jcfg.vocab_size, 2, 128)
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(tok))
    got, aux = PT.forward(pcfg, model, torch.from_numpy(tok))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128, jcfg.vocab_size)
    assert float(aux.aux_loss) == 0.0
    _close(got, want, F32)
    jh, _ = JT.forward_hidden(jcfg, jparams, jnp.asarray(tok))
    _close(model.forward_hidden(torch.from_numpy(tok))[0], jh, F32)


def _serve(step_fn, prefill_fn, tok, t_prompt, max_len, n_steps):
    """Prefill then teacher-forced decode: -> (prefill logits, [step
    logits], [(cache k, cache v) after prefill and after each step])."""
    logits, cache = prefill_fn(tok[:, :t_prompt], max_len)
    caches = [(_np(cache.k), _np(cache.v))]
    steps = []
    for t in range(t_prompt, t_prompt + n_steps):
        step, cache = step_fn(tok[:, t:t + 1], cache)
        steps.append(step)
        caches.append((_np(cache.k), _np(cache.v)))
    return logits, steps, caches


@pytest.mark.parametrize("port_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax_chunked(arch, port_impl):
    """prefill (T=32 into a 64-position cache) and 4 decode steps against
    JAX's "chunked" path: logits and both caches after every step. The
    port's "pallas" runs the flash kernel's plain version with the
    kernel's cache arguments (q_offset 0 / kv_len T; causal off / kv_len
    pos + 1), which JAX's own Pallas path refuses."""
    jcfg, pcfg = _configs(arch, "chunked", port_impl)
    jparams, model = _models(jcfg, pcfg)
    tok = _tokens(jcfg.vocab_size, 2, 36, seed=1)
    jl, jsteps, jcaches = _serve(
        lambda x, c: JT.decode_step(jcfg, jparams, x, c),
        lambda x, n: JT.prefill(jcfg, jparams, x, max_len=n), jnp.asarray(tok), 32, 64, 4)
    pl, psteps, pcaches = _serve(
        lambda x, c: PT.decode_step(pcfg, model, x, c),
        lambda x, n: PT.prefill(pcfg, model, x, max_len=n), torch.from_numpy(tok), 32, 64, 4)
    assert tuple(pl.shape) == (2, 32, jcfg.vocab_size)
    _close(pl, jl, F32)
    for got, want in zip(psteps, jsteps):
        _close(got, want, F32)
    for (pk, pv), (jk, jv) in zip(pcaches, jcaches):
        np.testing.assert_allclose(pk, jk, **F32)
        np.testing.assert_allclose(pv, jv, **F32)
    last, _ = PT.prefill(pcfg, model, torch.from_numpy(tok[:, :32]), 64, full_logits=False)
    _close(last, pl[:, -1], F32)


def test_bf16_prefill_and_decode_match_jax():
    """The stablelm smoke configuration in bfloat16 (the full
    configuration's type): prefill + 4 decode steps against JAX's chunked
    path, at 1/32 of the largest logit (the module docstring)."""
    jcfg, pcfg = _configs("stablelm", "chunked", "pallas", dtype="bf16")
    jparams, model = _models(jcfg, pcfg)
    tok = _tokens(jcfg.vocab_size, 2, 36, seed=2)
    jl, jsteps, _ = _serve(lambda x, c: JT.decode_step(jcfg, jparams, x, c),
                           lambda x, n: JT.prefill(jcfg, jparams, x, max_len=n),
                           jnp.asarray(tok), 32, 64, 4)
    pl, psteps, _ = _serve(lambda x, c: PT.decode_step(pcfg, model, x, c),
                           lambda x, n: PT.prefill(pcfg, model, x, max_len=n),
                           torch.from_numpy(tok), 32, 64, 4)
    for got, want in [(pl, jl)] + list(zip(psteps, jsteps)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=np.abs(want).max() / 32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_forward(arch):
    """The JAX test's own self-consistency (tests/test_configs_smoke.py):
    a decode step at position t gives the forward's logits at t."""
    _jcfg, pcfg = _configs(arch, "pallas", "chunked")
    model = PT.init_params(0, pcfg, device="cpu")
    tok = torch.from_numpy(_tokens(pcfg.vocab_size, 2, 32, seed=3))
    _, cache = model.prefill(tok[:, :16], max_len=64)
    step, cache = model.decode_step(tok[:, 16:17], cache)
    full, _ = model(tok[:, :17])
    np.testing.assert_allclose(_np(step), _np(full[:, 16]), rtol=5e-2, atol=5e-3)
    assert cache.length == 17


# ----------------------------------------------------- params and configs
@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_jax_keeps_every_leaf(arch):
    """Stacked (L, ...) leaves, the untied head and bfloat16 bits cross
    unchanged."""
    jcfg, pcfg = _configs(arch, "auto", "auto", dtype="bf16")
    jparams, model = _models(jcfg, pcfg)
    assert model.lm_head is not None and model.embed.dtype == torch.bfloat16
    for name, leaf in jparams["layers"].items():
        got = model.layers[name]
        assert tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(_np(got), _np(leaf))
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(_np(getattr(model, name)), _np(jparams[name]))
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count() == pcfg.param_count()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_jax(arch):
    jmod, pmod = ARCHS[arch]
    for make in ("make_full", "make_smoke"):
        jc, pc = getattr(jmod, make)(), getattr(pmod, make)()
        ja, pa = dataclasses.asdict(jc), dataclasses.asdict(pc)
        assert str(jnp.dtype(ja.pop("dtype"))) == str(pa.pop("dtype")).replace("torch.", "")
        assert ja == pa
        assert jc.param_count() == pc.param_count()
    assert pmod.SPEC.shapes == tuple(pconfigs.base.ShapeSpec(s.name, s.kind, s.params)
                                     for s in jmod.SPEC.shapes)
    assert (pmod.SPEC.name, pmod.SPEC.source) == (jmod.SPEC.name, jmod.SPEC.source)


def test_registry_has_ported_archs_only():
    assert pconfigs.list_archs() == ["stablelm-1.6b", "starcoder2-15b"]
    assert pconfigs.get("stablelm-1.6b").make_full().param_count() == 1_644_267_520
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pconfigs.get("mistral-large-123b")
    with pytest.raises(KeyError):
        pconfigs.get("no-such-arch")


def test_moe_is_not_ported():
    cfg = dataclasses.replace(p_stablelm.make_smoke(), n_experts=4, top_k=2, d_ff_expert=32)
    with pytest.raises(NotImplementedError, match="MoE"):
        PT.init_params(0, cfg, device="cpu")


def test_lm_synthetic_batch_matches_jax():
    for seed, step in ((0, 0), (3, 17)):
        got = ppipeline.lm_synthetic_batch(1000, 3, 50)(seed, step)
        want = jpipeline.lm_synthetic_batch(1000, 3, 50)(seed, step)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k], want[k])
