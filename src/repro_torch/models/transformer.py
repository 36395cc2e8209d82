"""Decoder-only transformer LM, serving path (counterpart of
``repro.models.transformer``): the cache-free forward, prefill and the
decode step, with a KV cache in JAX's layout (L, B, Hkv, S_max, dh).

Parameters keep JAX's tree: ``embed`` (V, d), ``layers`` (each leaf
stacked on a leading L axis), ``final_norm`` (d,), ``lm_head`` (d, V)
unless tied. A `Transformer` module holds them; the functions of JAX's
names take ``(cfg, params, ...)`` as JAX's do, with the module as
``params``, so one set of weights can run under another configuration
(``dataclasses.replace(cfg, attn_impl=...)``). Layers run in a Python
loop over views of the stacked leaves, in place of JAX's ``lax.scan``.

Every attention goes through `layers.attention`, so with the
configurations' ``attn_impl="chunked"`` each one of forward, prefill and
decode_step launches the flash kernel on the card. Unlike JAX, prefill and
decode_step write the cache in place (no copy of a cache that is several
GB); the returned `KVCache` shares the tensors it was given.

Not ported yet (ROADMAP.md): MoE layers (``cfg.is_moe`` raises), ``loss_fn``
and training. The pjit-only fields of the configuration are kept so that
configurations read alike, and ignored; so is ``remat`` (no backward).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- MoE (n_experts == 0 -> dense FFN); not ported yet
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- misc
    mlp_type: str = "swiglu"  # swiglu (3 mats) | gelu (2 mats, starcoder2)
    # JAX pjit sharding knobs: kept so configurations read alike, ignored here
    act_sharding: Any = None
    q_sharding: Any = None
    kv_sharding: Any = None
    gqa_repeat: bool = False
    logits_sharding: Any = None
    loss_chunk: int = 0
    ep_config: Any = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # ignored: no backward in the port yet
    attn_impl: str = "auto"  # auto|full|chunked|pallas
    attn_chunk: int = 1024
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters N."""
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        n_mats = 2 if self.mlp_type == "gelu" else 3
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * self.d_ff_expert
        else:
            ffn = n_mats * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        head = 0 if self.tie_embeddings else d * self.vocab_size
        return self.n_layers * per_layer + self.vocab_size * d + d + head


def _no_moe(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported to repro_torch yet (ROADMAP.md, 'Next')")


def _layer_shapes(cfg: TransformerConfig) -> dict:
    """Each stacked layer leaf's shape without the L axis, and its init scale."""
    d, dh, hq, hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    shapes = {"rms1": (d,), "rms2": (d,), "wq": (d, hq * dh), "wk": (d, hkv * dh),
              "wv": (d, hkv * dh), "wo": (hq * dh, d), "w1": (d, cfg.d_ff),
              "w2": (cfg.d_ff, d)}
    if cfg.mlp_type != "gelu":
        shapes["w3"] = (d, cfg.d_ff)
    return shapes


class Transformer(nn.Module):
    """The parameters of one LM, in JAX's tree (``layers`` stacked on L)."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor, layers: dict,
                 final_norm: torch.Tensor, lm_head: torch.Tensor | None = None):
        super().__init__()
        _no_moe(cfg)
        self.cfg = cfg
        want = _layer_shapes(cfg)
        if set(layers) != set(want):
            raise ValueError(f"layer leaves {sorted(layers)} != {sorted(want)} for {cfg.name}")
        for name, shape in want.items():
            if tuple(layers[name].shape) != (cfg.n_layers, *shape):
                raise ValueError(f"layers.{name} is {tuple(layers[name].shape)}, "
                                 f"want {(cfg.n_layers, *shape)}")
        if tuple(embed.shape) != (cfg.vocab_size, cfg.d_model):
            raise ValueError(f"embed is {tuple(embed.shape)}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError("lm_head must be given exactly when embeddings are untied")

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = param(embed)
        self.layers = nn.ParameterDict({k: param(t) for k, t in layers.items()})
        self.final_norm = param(final_norm)
        self.lm_head = None if lm_head is None else param(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer(self, i: int) -> dict:
        """Layer i's leaves (views of the stacked tensors)."""
        return {k: t[i] for k, t in self.layers.items()}

    def head(self, dtype: torch.dtype) -> torch.Tensor:
        return (self.embed.T if self.lm_head is None else self.lm_head).to(dtype)

    def forward(self, tokens, positions=None):
        return forward(self.cfg, self, tokens, positions)

    def forward_hidden(self, tokens):
        return forward_hidden(self.cfg, self, tokens)

    def prefill(self, tokens, max_len: int, full_logits: bool = True):
        return prefill(self.cfg, self, tokens, max_len, full_logits)

    def decode_step(self, tokens, cache):
        return decode_step(self.cfg, self, tokens, cache)


# ------------------------------------------------------------------ params
def init_params(seed: int, cfg: TransformerConfig, device=None) -> Transformer:
    """Random parameters at JAX's scales (``transformer.init_params``):
    normal x ``shape[-2]**-0.5`` for matrices (``d_ff**-0.5`` for the down
    projection), 0.02 for the embedding, ones for the norms. Drawn on the
    device from a ``torch.Generator`` seeded with ``seed``; ``jax.random``
    gives other numbers from the same seed."""
    _no_moe(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, n = cfg.dtype, cfg.n_layers

    def normal(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] ** -0.5 if len(shape) >= 2 else 0.02)
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return t.mul_(scale).to(dt)

    layers = {}
    for name, shape in _layer_shapes(cfg).items():
        if name.startswith("rms"):
            layers[name] = torch.ones((n, *shape), dtype=dt, device=dev)
        elif name == "w2":
            layers[name] = normal(n, *shape, scale=cfg.d_ff ** -0.5)
        else:
            layers[name] = normal(n, *shape)
    embed = normal(cfg.vocab_size, cfg.d_model, scale=0.02)
    head = None if cfg.tie_embeddings else normal(cfg.d_model, cfg.vocab_size)
    return Transformer(cfg, embed, layers, torch.ones((cfg.d_model,), dtype=dt, device=dev), head)


def _tensor(a, device) -> torch.Tensor:
    """A numpy-convertible array (numpy, or a JAX array) as a tensor;
    bfloat16 crosses as its bits."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params: dict, cfg: TransformerConfig, device=None) -> Transformer:
    """The port's module holding the JAX package's parameter tree
    (``repro.models.transformer.init_params``'s dict, with numpy or JAX
    leaves), stacked ``(L, ...)`` layer leaves and an untied ``lm_head``
    included. Values and types are kept bit for bit."""
    dev = resolve_device(device)
    layers = {k: _tensor(v, dev) for k, v in params["layers"].items()}
    head = params.get("lm_head")
    return Transformer(cfg, _tensor(params["embed"], dev), layers,
                       _tensor(params["final_norm"], dev),
                       None if head is None else _tensor(head, dev))


# ----------------------------------------------------------------- forward
class LayerAux(NamedTuple):
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, Hkv, S_max, dh)
    v: torch.Tensor  # (L, B, Hkv, S_max, dh)
    length: int  # filled positions, the same for every sequence


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.dh)
    dt = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                   v=torch.zeros(shape, dtype=dt, device=dev), length=0)


def _layer_fwd(cfg: TransformerConfig, lp: dict, x: torch.Tensor, cos, sin, *,
               causal: bool = True, q_offset: int = 0, kv_cache=None, cache_pos: int = 0):
    """One decoder layer; ``kv_cache`` (B, Hkv, S, dh) x2 is written in place."""
    B, T, _d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    h = L.rms_norm(x, lp["rms1"])
    q = (h @ lp["wq"]).reshape(B, T, hq, dh).transpose(1, 2)
    kk = (h @ lp["wk"]).reshape(B, T, hkv, dh).transpose(1, 2)
    vv = (h @ lp["wv"]).reshape(B, T, hkv, dh).transpose(1, 2)
    q = L.apply_rope(q, cos, sin)
    kk = L.apply_rope(kk, cos, sin)
    kv_len = None
    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_pos + T > ck.shape[2]:
            raise ValueError(f"cache of {ck.shape[2]} positions cannot take positions "
                             f"{cache_pos}..{cache_pos + T - 1}")
        ck[:, :, cache_pos:cache_pos + T] = kk
        cv[:, :, cache_pos:cache_pos + T] = vv
        kk, vv = ck, cv
        kv_len = cache_pos + T
    attn = L.attention(q, kk, vv, causal=causal, q_offset=q_offset, kv_len=kv_len,
                       impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    x = x + attn.transpose(1, 2).reshape(B, T, hq * dh) @ lp["wo"]
    h2 = L.rms_norm(x, lp["rms2"])
    if cfg.mlp_type == "gelu":
        return x + L.gelu_mlp(h2, lp["w1"], lp["w2"])
    return x + L.swiglu(h2, lp["w1"], lp["w3"], lp["w2"])


def _embed(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.to(params.device).long()].to(cfg.dtype)


def _zero_aux(device) -> LayerAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return LayerAux(z, z)


def forward_hidden(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor,
                   positions: torch.Tensor | None = None):
    """Forward up to the final norm (no LM head) -> ((B, T, d), aux)."""
    _no_moe(cfg)
    x = _embed(cfg, params, tokens)
    pos = (torch.arange(tokens.shape[1], device=params.device) if positions is None
           else positions.to(params.device))
    cos, sin = L.rope_angles(pos, cfg.dh, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, params.layer(i), x, cos, sin)
    return L.rms_norm(x, params.final_norm), _zero_aux(params.device)


def forward(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor,
            positions: torch.Tensor | None = None):
    """Full forward -> (logits (B, T, V) float32, aux). No cache."""
    x, aux = forward_hidden(cfg, params, tokens, positions)
    return (x @ params.head(cfg.dtype)).float(), aux


def prefill(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor, max_len: int,
            full_logits: bool = True):
    """Prefill a prompt (B, T), building a cache of ``max_len`` positions.
    -> (logits (B, T, V), or (B, V) at the last position with
    ``full_logits=False`` as a server calls it; the cache)."""
    _no_moe(cfg)
    B, T = tokens.shape
    cache = init_cache(cfg, B, max_len, device=params.device)
    x = _embed(cfg, params, tokens)
    cos, sin = L.rope_angles(torch.arange(T, device=params.device), cfg.dh, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, params.layer(i), x, cos, sin, causal=True, q_offset=0,
                       kv_cache=(cache.k[i], cache.v[i]), cache_pos=0)
    x = L.rms_norm(x, params.final_norm)
    if not full_logits:
        x = x[:, -1, :]
    logits = (x @ params.head(cfg.dtype)).float()
    return logits, KVCache(k=cache.k, v=cache.v, length=T)


def decode_step(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor,
                cache: KVCache):
    """One autoregressive step: tokens (B, 1), the next token of every
    sequence -> (logits (B, V) float32, the cache one position longer)."""
    _no_moe(cfg)
    pos = int(cache.length)
    x = _embed(cfg, params, tokens)  # (B, 1, d)
    # a fill on the device, not a copy from the host, which would wait for the card
    positions = torch.full((1,), pos, dtype=torch.int64, device=params.device)
    cos, sin = L.rope_angles(positions, cfg.dh, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, params.layer(i), x, cos, sin, causal=False, q_offset=pos,
                       kv_cache=(cache.k[i], cache.v[i]), cache_pos=pos)
    x = L.rms_norm(x, params.final_norm)
    logits = (x[:, 0, :] @ params.head(cfg.dtype)).float()
    return logits, KVCache(k=cache.k, v=cache.v, length=pos + 1)
