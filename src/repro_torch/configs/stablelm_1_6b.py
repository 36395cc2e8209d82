"""stablelm-1.6b — [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (GQA kv=32 == MHA) d_ff=5632 vocab=100352.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_full() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-1.6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        rope_theta=10000.0,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        attn_impl="chunked",
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=176,
        vocab_size=512,
        tie_embeddings=False,
        dtype=torch.float32,
        attn_impl="auto",
    )


SPEC = ArchSpec(
    name="stablelm-1.6b",
    family="lm",
    make_full=make_full,
    make_smoke=make_smoke,
    shapes=LM_SHAPES,
    source="hf:stabilityai/stablelm-2-1_6b",
)
