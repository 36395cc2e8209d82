"""Transformer building blocks (counterpart of ``repro.models.layers``):
RMSNorm, RoPE, SwiGLU and attention.

Float32 math on the model's storage type, as in JAX. Layouts are JAX's:
attention takes q (B, Hq, T, dh) and k, v (B, Hkv, S, dh).

Attention has these execution paths (``attention(impl=...)``):

* ``full_attention``: materialises the (T, S) scores (JAX's ``"full"``);
* ``chunked_attention``: the online-softmax double loop of JAX's
  ``"chunked"``, the plain version of the flash kernel;
* the hand-written CUDA kernel ``repro_torch.kernels.flash_attention``:
  on a CUDA tensor, impl ``"chunked"``, ``"pallas"`` and ``"full_masked"``
  (decode) all launch it. On a CPU tensor they take their plain code.

A cache's valid prefix is given as ``kv_len`` (JAX builds the mask
``arange(S) < kv_len``, the only mask its transformer makes), so the
kernel can skip the tiles past it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30

# impls that launch the flash kernel on a CUDA tensor
KERNEL_IMPLS = ("chunked", "pallas", "full_masked")


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * gamma.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin tables for RoPE, float32. positions (...,) -> (..., head_dim/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device)
                             / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, T, dh); cos/sin (B, T, dh/2) or (T, dh/2). Rotates the two
    halves of the head dim (not interleaved pairs), in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (T, half) -> broadcast over B, H
        cos_b, sin_b = cos[None, None], sin[None, None]
    else:  # (B, T, half) -> broadcast over H
        cos_b, sin_b = cos[:, None], sin[:, None]
    out1 = x1 * cos_b - x2 * sin_b
    out2 = x2 * cos_b + x1 * sin_b
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q (B, Hq, T, dh) in float32, scaled by dh**-0.5, as (B, Hkv, g, T, dh)."""
    B, Hq, T, dh = q.shape
    return (q.float() * (dh ** -0.5)).reshape(B, n_kv, Hq // n_kv, T, dh)


def _masked_softmax_attention(q, k, v, *, causal: bool, q_offset: int, kv_mask=None):
    """The (T, S) scores of every head at once, masked with -1e30."""
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qf = _grouped(q, Hkv)
    scores = qf @ k.float()[:, :, None].transpose(-1, -2)  # (B, Hkv, g, T, S)
    if causal:
        qpos = torch.arange(T, device=q.device) + q_offset
        cmask = qpos[:, None] >= torch.arange(S, device=q.device)[None, :]
        scores = torch.where(cmask, scores, NEG_INF)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = w @ v.float()[:, :, None]
    return out.reshape(B, Hq, T, dh).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                   q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, T, dh), k/v (B, Hkv, S, dh) -> (B, Hq, T, dh). Materialises scores."""
    return _masked_softmax_attention(q, k, v, causal=causal, q_offset=q_offset)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      q_offset: int = 0, q_chunk: int = 1024, kv_chunk: int = 1024,
                      kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Online-softmax attention, O(q_chunk * kv_chunk) live scores: the
    plain version of the flash kernel.

    ``q_offset`` places the query block inside the kv stream (decode).
    ``kv_mask`` (B, S) optionally invalidates kv positions (padded cache).
    JAX asserts that the chunks divide T and S; here the last chunk may
    be shorter (a cache of 4,160 positions in chunks of 1,024), which for
    dividing chunks is the same schedule."""
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    group = Hq // Hkv
    q_chunk, kv_chunk = min(q_chunk, T), min(kv_chunk, S)
    qf = _grouped(q, Hkv)
    kf = k.float()[:, :, None]  # (B, Hkv, 1, S, dh)
    vf = v.float()[:, :, None]
    out = torch.empty((B, Hkv, group, T, dh), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, q_chunk):
        q1 = min(T, q0 + q_chunk)
        qc = qf[..., q0:q1, :]
        qpos = torch.arange(q0, q1, device=q.device) + q_offset
        shape = (B, Hkv, group, q1 - q0, 1)
        m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(shape, dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, group, q1 - q0, dh), dtype=torch.float32, device=q.device)
        for k0 in range(0, S, kv_chunk):
            k1 = min(S, k0 + kv_chunk)
            s = qc @ kf[..., k0:k1, :].transpose(-1, -2)
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            if kv_mask is not None:
                s = torch.where(kv_mask[:, None, None, None, k0:k1], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[..., k0:k1, :]
            m = m_new
        out[..., q0:q1, :] = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, T, dh).to(q.dtype)


def prefix_mask(batch: int, s_len: int, kv_len: int, device) -> torch.Tensor:
    """JAX's cache mask ``arange(S) < kv_len``, broadcast to (B, S)."""
    return (torch.arange(s_len, device=device) < kv_len)[None, :].expand(batch, s_len)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              q_offset: int = 0, kv_len: int | None = None, impl: str = "auto",
              chunk: int = 1024) -> torch.Tensor:
    """Dispatcher. impl: auto | full | chunked | pallas | full_masked.

    The rules are JAX's (``layers.attention``): ``"auto"`` is ``"full"``
    when T * S <= 4096**2 and there is no cache mask, else ``"chunked"``;
    ``"chunked"`` at T <= 16 (decode) becomes ``"full_masked"`` with a
    cache mask, else ``"full"``. ``kv_len`` is the cache's valid prefix
    (JAX's ``kv_mask``). On a CUDA tensor ``"chunked"``, ``"pallas"`` and
    ``"full_masked"`` launch the flash kernel; ``"full"`` stays plain, as
    JAX's ``full_attention`` is jnp. Unlike JAX's, the ``"pallas"`` path
    takes a cache."""
    T, S = q.shape[2], k.shape[2]
    if impl == "auto":
        impl = "full" if (T * S <= 4096 * 4096 and kv_len is None) else "chunked"
    if T <= 16 and impl == "chunked":
        impl = "full_masked" if kv_len is not None else "full"
    if impl not in KERNEL_IMPLS and impl != "full":
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "full_masked" and kv_len is None:
        raise ValueError("attention impl 'full_masked' needs a cache (kv_len)")
    if q.device.type == "cuda" and impl in KERNEL_IMPLS:
        return fa_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                      kv_len=S if kv_len is None else kv_len)
    if impl == "pallas":
        return fa_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if impl == "full":
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)
    kv_mask = None if kv_len is None else prefix_mask(q.shape[0], S, kv_len, q.device)
    if impl == "full_masked":
        return _masked_softmax_attention(q, k, v, causal=causal, q_offset=q_offset,
                                         kv_mask=kv_mask)
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset, q_chunk=chunk,
                             kv_chunk=chunk, kv_mask=kv_mask)


# ------------------------------------------------------------------ MLPs
def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """LLaMA-style gated MLP: (silu(x@w1) * (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """starcoder2's MLP: gelu(x@w1) @ w2, with the tanh approximation that
    ``jax.nn.gelu`` takes by default."""
    return F.gelu(x @ w1, approximate="tanh") @ w2
