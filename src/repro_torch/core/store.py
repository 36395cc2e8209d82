"""CandidateStore — the candidate store of the query engine (counterpart
of ``repro.core.store``).

Stage (iii) of the paper's pipeline filters LMI candidates by a cheap
vector distance over these rows:

  * ``data``    — the bucket-sorted embedding matrix, stored in
    ``float32`` (exact) or ``bfloat16`` (2x smaller; the paper's full
    configuration serves from bf16);
  * ``ids``     — CSR row -> original object id;
  * ``offsets`` — CSR bucket offsets (bucket ``b`` owns rows
    ``offsets[b]:offsets[b+1]``), which makes each query's candidate
    list a set of contiguous bucket runs of rows;
  * ``scales`` / ``norms`` — the dequantization scales and integer row
    norms of the quantized tiers; None for the two float stores.

The int8 and float8_e4m3fn tiers are accepted names (`validate_dtype`
knows them, so a meta.json naming one is recognised) but building such a
store raises NotImplementedError: they are the next slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

STORE_DTYPES = ("float32", "bfloat16", "int8", "float8_e4m3fn")

QUANTIZED_DTYPES = ("int8", "float8_e4m3fn")

SCALE_GRANULARITIES = ("row", "bucket")

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def validate_dtype(dtype: str, *, flag: str = "store dtype") -> str:
    """Fail fast on an unknown store dtype with the full menu, before any
    model is fitted."""
    if dtype not in STORE_DTYPES:
        raise ValueError(f"{flag} must be one of {STORE_DTYPES}, got {dtype!r}")
    return dtype


def validate_granularity(granularity: str) -> str:
    if granularity not in SCALE_GRANULARITIES:
        raise ValueError(
            f"scale granularity must be one of {SCALE_GRANULARITIES}, "
            f"got {granularity!r}"
        )
    return granularity


def require_supported(dtype: str) -> None:
    if dtype in QUANTIZED_DTYPES:
        raise NotImplementedError(
            f"{dtype} candidate stores are the next slice of the port (ROADMAP "
            "queue A: quantized tiers 1-4q); use float32 or bfloat16")


@dataclasses.dataclass(frozen=True)
class CandidateStore:
    dtype: str
    data: torch.Tensor  # (R, d) store-dtype embedding rows, bucket-sorted
    ids: torch.Tensor  # (R,) int32 original object ids
    offsets: torch.Tensor  # (L + 1,) int32 CSR bucket offsets
    scales: Optional[torch.Tensor] = None  # quantized tiers only
    norms: Optional[torch.Tensor] = None  # quantized tiers only
    # index_revision of the LMI this store was materialized from;
    # filtering rejects a store whose revision lags the index
    revision: int = 0
    scale_granularity: str = "row"

    @property
    def n_rows(self) -> int:
        return self.data.shape[-2]

    @property
    def dim(self) -> int:
        return self.data.shape[-1]

    @property
    def n_buckets(self) -> int:
        return self.offsets.shape[-1] - 1

    def nbytes(self, include_metadata: bool = True) -> int:
        """Device bytes of the store."""
        n = self.data.numel() * self.data.element_size()
        if include_metadata:
            n += self.ids.numel() * self.ids.element_size()
            n += self.offsets.numel() * self.offsets.element_size()
        return n


def quantize(embeddings: torch.Tensor, dtype: str, scale_granularity: str = "row",
             offsets=None):
    """(data, scales, norms) of ``embeddings`` in the store precision.

    bf16 is a round-to-nearest-even cast, the same rounding as JAX's
    ``astype(jnp.bfloat16)``, so both packages hold bitwise equal stores.
    """
    validate_dtype(dtype)
    validate_granularity(scale_granularity)
    require_supported(dtype)
    x = embeddings.float()
    return x.to(_TORCH_DTYPE[dtype]), None, None


def make_store(embeddings, ids, offsets, dtype: str = "float32", revision: int = 0,
               scale_granularity: str = "row") -> CandidateStore:
    data, scales, norms = quantize(embeddings, dtype, scale_granularity, offsets)
    return CandidateStore(
        dtype=dtype, data=data, ids=ids.to(torch.int32), offsets=offsets.to(torch.int32),
        scales=scales, norms=norms, revision=revision, scale_granularity=scale_granularity,
    )


def from_lmi(index, dtype: str = "float32", scale_granularity: str = "row") -> CandidateStore:
    """The store view of a built `repro_torch.core.lmi.LMI` (f32 shares
    the index's tensors). Stamps the index's ``index_revision``."""
    return make_store(index.sorted_embeddings, index.sorted_ids, index.bucket_offsets, dtype,
                      revision=index.index_revision, scale_granularity=scale_granularity)


def refresh(index, store: CandidateStore) -> CandidateStore:
    """Re-materialize ``store`` (same precision and granularity) from the
    index's current CSR arrays."""
    return from_lmi(index, store.dtype, store.scale_granularity)


def row_scales(store: CandidateStore) -> Optional[torch.Tensor]:
    """The store's dequant scales per CSR row: None for the float stores,
    the only ones this slice builds (per-bucket expansion comes with the
    quantized tiers)."""
    return store.scales


def gather_dequant(data: torch.Tensor, scales: Optional[torch.Tensor], rows: torch.Tensor):
    """Gather + dequantize candidate rows to float32: (..., C) -> (..., C, d).
    Materializes the gathered block on purpose (the plain filter)."""
    cand = data[rows].float()
    if scales is not None:
        cand = cand * scales[rows][..., None]
    return cand


def dequantize_rows(store: CandidateStore, rows: torch.Tensor) -> torch.Tensor:
    """`gather_dequant` over a CandidateStore."""
    return gather_dequant(store.data, row_scales(store), rows)
