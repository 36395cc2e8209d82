"""Config registry plumbing (counterpart of ``repro.configs.base``):
ArchSpec + the shared shape sets.

Every ported architecture contributes one module defining an ArchSpec:
``make_full()`` (the published configuration), ``make_smoke()`` (a
reduced same-family configuration the CPU tests run) and ``shapes`` (the
architecture's input-shape set).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | ...
    params: dict

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.params.items())
        return f"{self.name}[{self.kind}]({inner})"


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str
    make_full: Callable[[], Any]
    make_smoke: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}; has {[s.name for s in self.shapes]}")


# ------------------------------------------------- shared LM shape set
LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)
