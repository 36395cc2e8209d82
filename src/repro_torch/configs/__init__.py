"""Architecture registry of the port (counterpart of ``repro.configs``).

Only the ported architectures resolve. The JAX package's other
architectures raise `NotImplementedError` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

from repro_torch.configs import stablelm_1_6b, starcoder2_15b
from repro_torch.configs.base import LM_SHAPES, ArchSpec, ShapeSpec

_MODULES = (stablelm_1_6b, starcoder2_15b)

REGISTRY: dict[str, ArchSpec] = {m.SPEC.name: m.SPEC for m in _MODULES}

# architectures of the JAX package (repro.configs) the port does not have yet
NOT_PORTED = ("mistral-large-123b", "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b", "gatedgcn",
              "wide-deep", "xdeepfm", "mind", "dlrm-mlperf", "lmi-protein")


def get(name: str) -> ArchSpec:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (ROADMAP.md, 'Next'); "
            f"ported: {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")


def list_archs() -> list[str]:
    return sorted(REGISTRY)


__all__ = ["ArchSpec", "ShapeSpec", "LM_SHAPES", "REGISTRY", "get", "list_archs"]
