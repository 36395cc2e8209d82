"""CandidateStore — the candidate store of the query engine (counterpart
of ``repro.core.store``).

Stage (iii) of the paper's pipeline filters LMI candidates by a cheap
vector distance over these rows:

  * ``data``    — the bucket-sorted embedding matrix, stored in
    ``float32`` (exact), ``bfloat16`` (2x smaller; the paper's full
    configuration serves from bf16), ``int8`` or ``float8_e4m3fn`` (4x
    smaller, symmetric absmax scales: the serving memory knob);
  * ``scales``  — the dequantization scales of the quantized tiers, at
    ``scale_granularity`` "row" (one per row, (R,)) or "bucket" (one per
    CSR bucket, (L,)); None for the float stores;
  * ``norms``   — int8 only: the integer row norms ``sum(q_r^2)`` (int32,
    exact), which the integer-domain filter (``compute_dtype="int8"``)
    reads in place of ``|c|^2``;
  * ``ids``     — CSR row -> original object id;
  * ``offsets`` — CSR bucket offsets (bucket ``b`` owns rows
    ``offsets[b]:offsets[b+1]``), which makes each query's candidate
    list a set of contiguous bucket runs of rows.

Quantization contract, bit for bit the JAX package's: the rows of scale
group ``g`` (a row, or a whole CSR bucket) are stored as
``round(x / s_g)`` (int8, round half to even, clipped to +-127) or
``fp8(clip(x / s_g, +-448))`` (round to nearest even on the cast) with
``s_g = max(max|x_g|, 1e-12) / qmax``; dequant is ``q * s_g``, applied
after the gather.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

STORE_DTYPES = ("float32", "bfloat16", "int8", "float8_e4m3fn")

# dtypes that carry scales (and, for int8, prebuilt integer norms)
QUANTIZED_DTYPES = ("int8", "float8_e4m3fn")

SCALE_GRANULARITIES = ("row", "bucket")

# symmetric-quantization range: values map to [-qmax, qmax]
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}


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
        """Device bytes of the store (scales and norms included)."""
        n = self.data.numel() * self.data.element_size()
        for t in (self.scales, self.norms):
            if t is not None:
                n += t.numel() * t.element_size()
        if include_metadata:
            n += self.ids.numel() * self.ids.element_size()
            n += self.offsets.numel() * self.offsets.element_size()
        return n


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor``, correctly rounded on every device. PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which is off by
    one ulp for some values (absmax / 127 among them); a divisor tensor on
    ``x``'s device takes the true division, as the CPU and JAX do."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def _bucket_ids(offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(R,) int32 bucket id of every CSR row. Empty buckets produce
    duplicate offsets; a right-sided search minus 1 lands each row in the
    last bucket starting at or before it, the unique non-empty one."""
    n_buckets = offsets.shape[0] - 1
    rows = torch.arange(n_rows, dtype=offsets.dtype, device=offsets.device)
    rb = torch.searchsorted(offsets, rows, right=True) - 1
    return torch.clamp(rb, 0, n_buckets - 1).to(torch.int32)


def _quantize_2d(x: torch.Tensor, dtype: str, granularity: str,
                 offsets: Optional[torch.Tensor]):
    """One (R, d) f32 slab -> (data, scales, norms), as JAX's
    ``_quantize_2d``: divide by the scale (never multiply by a
    reciprocal), round half to even, clip."""
    qmax = _QMAX[dtype]
    absmax = torch.amax(torch.abs(x), dim=-1)  # (R,)
    if granularity == "row":
        scales = true_divide(torch.clamp(absmax, min=1e-12), qmax)
        row_s = scales
    else:
        rb = _bucket_ids(offsets, x.shape[0]).long()
        bmax = torch.full((offsets.shape[0] - 1,), float("-inf"), device=x.device)
        bmax = bmax.scatter_reduce(0, rb, absmax, "amax")
        # empty buckets keep -inf, JAX's segment_max; clamped so the scales
        # stay finite (nothing ever dequantizes against them)
        scales = true_divide(torch.clamp(bmax, min=1e-12), qmax)
        row_s = scales[rb]
    scaled = x / row_s[:, None]
    if dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
        qi = q.to(torch.int32)
        norms = torch.sum(qi * qi, dim=-1, dtype=torch.int32)  # exact, < 2^31
    else:  # float8_e4m3fn: clip to the finite range, round on the cast
        q = torch.clamp(scaled, -qmax, qmax).to(torch.float8_e4m3fn)
        norms = None
    return q, scales, norms


def quantize(embeddings: torch.Tensor, dtype: str, scale_granularity: str = "row",
             offsets=None):
    """(data, scales, norms) of (R, d) ``embeddings`` in the store
    precision, on their device.

    bf16 is a round-to-nearest-even cast, the same rounding as JAX's
    ``astype(jnp.bfloat16)``, so both packages hold bitwise equal stores;
    int8 and fp8 follow the module's quantization contract (bitwise JAX's
    too). ``scale_granularity="bucket"`` shares one scale across each CSR
    bucket (``offsets`` required). ``norms`` is the int8 tier's integer
    row norm (None otherwise).
    """
    validate_dtype(dtype)
    validate_granularity(scale_granularity)
    x = embeddings.float()
    if dtype == "float32":
        return x, None, None
    if dtype == "bfloat16":
        return x.to(torch.bfloat16), None, None
    if scale_granularity == "bucket":
        if offsets is None:
            raise ValueError("scale_granularity='bucket' requires CSR offsets")
        offsets = torch.as_tensor(offsets, dtype=torch.int32, device=x.device)
    return _quantize_2d(x, dtype, scale_granularity, offsets)


def make_store(embeddings, ids, offsets, dtype: str = "float32", revision: int = 0,
               scale_granularity: str = "row") -> CandidateStore:
    offsets = offsets.to(torch.int32)
    data, scales, norms = quantize(embeddings, dtype, scale_granularity, offsets)
    return CandidateStore(
        dtype=dtype, data=data, ids=ids.to(torch.int32), offsets=offsets,
        scales=scales, norms=norms, revision=revision, scale_granularity=scale_granularity,
    )


def from_lmi(index, dtype: str = "float32", scale_granularity: str = "row") -> CandidateStore:
    """The store view of a built `repro_torch.core.lmi.LMI` (f32 shares
    the index's tensors), quantized on the index's device. Stamps the
    index's ``index_revision``."""
    return make_store(index.sorted_embeddings, index.sorted_ids, index.bucket_offsets, dtype,
                      revision=index.index_revision, scale_granularity=scale_granularity)


def refresh(index, store: CandidateStore) -> CandidateStore:
    """Re-materialize ``store`` (same precision and granularity) from the
    index's current CSR arrays."""
    return from_lmi(index, store.dtype, store.scale_granularity)


def expand_bucket_scales(scales: torch.Tensor, offsets: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Per-bucket scales (L,) as a per-row view (R,): each repeated by its
    bucket's size."""
    return torch.repeat_interleave(scales, torch.diff(offsets.long()), output_size=n_rows)


def row_scales(store: CandidateStore) -> Optional[torch.Tensor]:
    """The store's dequant scales per CSR row, whatever the granularity
    (None for the float stores): what every per-slot consumer indexes by
    row. Bucket scales are expanded by bucket size, a transient tensor
    that is never stored."""
    if store.scales is None or store.scale_granularity == "row":
        return store.scales
    return expand_bucket_scales(store.scales, store.offsets, store.n_rows)


def gather_dequant(data: torch.Tensor, scales: Optional[torch.Tensor], rows: torch.Tensor):
    """Gather + dequantize candidate rows to float32: (..., C) -> (..., C, d).
    ``scales`` is the per-row view (`row_scales`). Materializes the
    gathered block on purpose (the plain filter)."""
    cand = data[rows].float()
    if scales is not None:
        cand = cand * scales[rows][..., None]
    return cand


def dequantize_rows(store: CandidateStore, rows: torch.Tensor) -> torch.Tensor:
    """`gather_dequant` over a CandidateStore."""
    return gather_dequant(store.data, row_scales(store), rows)


def dequantize(store: CandidateStore) -> torch.Tensor:
    """The full store back in float32 (tests / round-trip checks)."""
    x = store.data.float()
    scales = row_scales(store)
    if scales is not None:
        x = x * scales[:, None]
    return x
