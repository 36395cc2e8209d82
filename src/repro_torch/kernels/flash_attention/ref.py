"""Plain PyTorch version of the flash_attention kernel.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref`` (full score
rows, softmax, weighted sum; math in float32, output in q's dtype) with
the kernel's arguments: query row t sits at kv position ``q_offset + t``
and sees kv position s iff ``s < kv_len`` and, when causal,
``s <= q_offset + t``. Masked scores are -1e30, as in the kernel and in
JAX's chunked attention, so a row's weights stay finite. Rows are taken
``q_block`` at a time, so the (T, S) scores of a long prompt never exist
at once (4 x 32 heads x 4,096 x 4,160 float32 would be 8.7 GB).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int | None = None,
                        kv_len: int | None = None, q_block: int = 1024) -> torch.Tensor:
    """q (B, Hq, T, dh); k, v (B, Hkv, S, dh) -> (B, Hq, T, dh) in q's dtype.

    ``q_offset`` defaults to ``S - T`` and ``kv_len`` to ``S``: the
    function of the TPU kernel (queries at the end of the kv stream)."""
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} / {Hkv}")
    group = Hq // Hkv
    q_offset = S - T if q_offset is None else int(q_offset)
    kv_len = S if kv_len is None else int(kv_len)
    kf = k.float()[:, :, None]  # (B, Hkv, 1, S, dh)
    vf = v.float()[:, :, None]
    kpos = torch.arange(S, device=q.device)
    out = torch.empty((B, Hkv, group, T, dh), dtype=torch.float32, device=q.device)
    qg = q.reshape(B, Hkv, group, T, dh)
    for t0 in range(0, T, q_block):
        t1 = min(T, t0 + q_block)
        qf = qg[..., t0:t1, :].float() * (dh ** -0.5)
        s = qf @ kf.transpose(-1, -2)  # (B, Hkv, g, tq, S)
        ok = (kpos < kv_len)[None, :]
        if causal:
            qpos = torch.arange(t0, t1, device=q.device) + q_offset
            ok = ok & (kpos[None, :] <= qpos[:, None])
        s = torch.where(ok, s, NEG_INF)
        w = torch.exp(s - s.amax(dim=-1, keepdim=True))
        w = w / w.sum(dim=-1, keepdim=True)
        out[..., t0:t1, :] = w @ vf
    return out.reshape(B, Hq, T, dh).to(q.dtype)
