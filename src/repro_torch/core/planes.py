"""IndexPlanes: the canonical node planes of the segmented beam, built
once (counterpart of ``repro.core.planes``).

`lmi.beam_leaf_ranking(node_eval="segmented")` reads each pruned level
through `repro_torch.kernels.beam_eval`, whose operands are the
`beam_eval.ops.family_planes` planes (at most two (N, arity, d)
matrices plus (N, arity) vector planes per level). Without prebuilt
planes they are canonicalized in every query batch, an O(N * arity * d)
read of the raw level params. This module materializes them once, at
build time (saved beside the index by `repro_torch.index_io.save_index`)
or on first use (`from_lmi`), keyed on the index's ``index_revision``
and the temperature schedule folded into them:

  * `from_lmi(index, temperatures)` canonicalizes levels 1..depth-1;
  * query entry points `validate` revision, temperatures and depth, and
    raise on a mismatch instead of scoring with stale planes;
  * `refresh(index, planes)` rebuilds them at the same temperatures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import lmi as lmi_lib


@dataclasses.dataclass(frozen=True)
class IndexPlanes:
    """Prebuilt `beam_eval.ops.Planes` of every prunable level.

    ``levels[i - 1]`` holds level ``i``'s planes (levels 1..depth-1);
    ``temperatures`` is the full per-level schedule they were folded with
    (`lmi.normalize_temperatures` form); ``revision`` the
    ``index_revision`` of the LMI they were built from."""

    temperatures: tuple
    levels: tuple  # of beam_eval.ops.Planes, one per level >= 1
    revision: int = 0

    @property
    def depth(self) -> int:
        return len(self.levels) + 1

    def level_planes(self, level: int):
        """The planes of (1-indexed) pruned level ``level``."""
        return self.levels[level - 1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pl in self.levels for t in (*pl.mats, *pl.vecs))

    def to(self, device) -> "IndexPlanes":
        """The same planes with every tensor on ``device``."""
        from repro_torch.kernels.beam_eval.ops import Planes

        device = torch.device(device)
        return dataclasses.replace(self, levels=tuple(
            Planes(mats=tuple(m.to(device) for m in pl.mats),
                   vecs=tuple(v.to(device) for v in pl.vecs))
            for pl in self.levels))


def from_lmi(index, temperatures=None) -> IndexPlanes:
    """Canonicalize every prunable level of a built LMI at the serving
    ``temperatures`` (scalar / per-level / None == all 1.0)."""
    from repro_torch.kernels.beam_eval import ops as be_ops

    temps = lmi_lib.normalize_temperatures(temperatures, index.depth)
    levels = tuple(be_ops.family_planes(index.model_type, index.levels[i], temperature=temps[i])
                   for i in range(1, index.depth))
    return IndexPlanes(temperatures=temps, levels=levels, revision=index.index_revision)


def refresh(index, planes: IndexPlanes) -> IndexPlanes:
    """Re-canonicalize ``planes`` (same temperatures) from the index's
    current params and revision."""
    return from_lmi(index, planes.temperatures)


def validate(index, planes: Optional[IndexPlanes], temperatures=None) -> Optional[IndexPlanes]:
    """``planes`` (or None) when consistent with ``index`` and the query's
    ``temperatures``; raises ValueError on a stale revision, other
    temperatures or another depth."""
    if planes is None:
        return None
    if planes.revision != index.index_revision:
        raise ValueError(
            f"stale IndexPlanes: planes revision {planes.revision} != index "
            f"revision {index.index_revision} (the index changed after the planes "
            "were built) — refresh them with planes.refresh(index, planes)")
    temps = lmi_lib.normalize_temperatures(temperatures, index.depth)
    if tuple(planes.temperatures) != temps:
        raise ValueError(
            f"IndexPlanes were folded with temperatures {planes.temperatures} "
            f"but the query asked for {temps} — rebuild them with "
            "planes.from_lmi(index, temperatures) for this schedule")
    if len(planes.levels) != index.depth - 1:
        raise ValueError(
            f"IndexPlanes cover {len(planes.levels)} prunable levels but the "
            f"index has depth {index.depth} ({index.depth - 1} prunable)")
    return planes
