"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_full() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-15b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        mlp_type="gelu",
        rope_theta=100000.0,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        attn_impl="chunked",
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-smoke",
        n_layers=2,
        d_model=96,
        n_heads=8,
        n_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        mlp_type="gelu",
        tie_embeddings=False,
        dtype=torch.float32,
        attn_impl="auto",
    )


SPEC = ArchSpec(
    name="starcoder2-15b",
    family="lm",
    make_full=make_full,
    make_smoke=make_smoke,
    shapes=LM_SHAPES,
    source="arXiv:2402.19173",
)
