"""Index I/O of the port — the seam where JAX-built and port-built
indexes cross over.

The on-disk layout is the JAX package's format 2 (docs/index_format.md):

    <dir>/meta.json    arities, model_type, n_sections, n_objects,
                       max_bucket_size, serving defaults, ...
    <dir>/step_0.npz   one array per pytree leaf, keyed by its
                       ``jax.tree_util.keystr`` path, e.g.
                       ``['levels'][0]['centroids']``, ``['bucket_offsets']``

Legacy format-1 checkpoints keep a 2-level stack under
``['l1_params']`` / ``['l2_params']``. JAX writes a ``__treedef__`` entry
beside the leaves and its ``restore`` ignores it; so does this reader.
Everything here is numpy + ``json``: an index written by the port loads
with ``repro.launch.build_index.load_index`` and the reverse.
"""
from __future__ import annotations

import json
import math
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import planes as planes_lib
from repro_torch.core.lmi import LMI, MODEL_TYPES
from repro_torch.kernels.beam_eval.ops import _FAMILY_SHAPES, Planes


def _key(*path) -> str:
    """``jax.tree_util.keystr`` of a dict / tuple path."""
    return "".join(f"[{p!r}]" for p in path)


def index_from_numpy(levels, bucket_offsets, sorted_ids, sorted_embeddings, *,
                     arities, model_type: str, max_bucket_size: int = 0,
                     index_revision: int = 0, device=None) -> LMI:
    """The port's `LMI` from host arrays (e.g. ``np.asarray`` of the
    leaves of a JAX ``LMI``): levels is a sequence of dicts of arrays."""
    dev = resolve_device(device)
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}")

    def t(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    offsets = np.asarray(bucket_offsets)
    if not max_bucket_size:
        max_bucket_size = int((offsets[1:] - offsets[:-1]).max())
    return LMI(
        arities=tuple(int(a) for a in arities),
        model_type=model_type,
        levels=tuple({k: t(v, np.float32) for k, v in lv.items()} for lv in levels),
        bucket_offsets=t(offsets, np.int32),
        sorted_ids=t(sorted_ids, np.int32),
        sorted_embeddings=t(sorted_embeddings, np.float32),
        max_bucket_size=int(max_bucket_size),
        index_revision=int(index_revision),
    )


def _planes_key(level: int, kind: str, m: int) -> str:
    """``keystr`` of a leaf of ``{"levels": (Planes, ...)}``, e.g.
    ``['levels'][0].mats[1]`` (Planes is a named tuple: attribute keys)."""
    return f"['levels'][{level}].{kind}[{m}]"


def _write_npz(directory: str, leaves: dict, treedef: str) -> None:
    """``<directory>/step_0.npz`` written atomically (tmp, fsync, rename),
    as the JAX package's checkpoint ``save`` does."""
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __treedef__=np.frombuffer(treedef.encode(), dtype=np.uint8), **leaves)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, "step_0.npz"))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_index(directory: str, index: LMI, *, n_sections: int, cutoff: float, seed: int = 0,
               store_dtype: str = "float32", beam_width=None, beam_widths=None,
               temperatures=None, node_eval: str = "gather", prebuilt_planes: bool = False,
               scale_granularity: str = "row", compute_dtype: str = "float32",
               **extra_meta) -> None:
    """Persist a built LMI as format 2 (atomic npz + meta.json).

    The optional meta keys are written only when set or not the default,
    as the JAX package does: ``scale_granularity`` (not "row"),
    ``compute_dtype`` (not "float32"), ``beam_widths`` (a per-level
    schedule), ``temperatures``, and
    with ``prebuilt_planes=True`` the canonical node planes of
    `core.planes.from_lmi` under ``<dir>/planes/step_0.npz`` plus a
    ``prebuilt_planes`` key with their revision and temperatures."""
    leaves = {}
    for i, lv in enumerate(index.levels):
        for name, v in lv.items():
            leaves[_key("levels", i, name)] = v.detach().cpu().numpy()
    leaves[_key("bucket_offsets")] = index.bucket_offsets.cpu().numpy()
    leaves[_key("sorted_ids")] = index.sorted_ids.cpu().numpy()
    leaves[_key("sorted_embeddings")] = index.sorted_embeddings.cpu().numpy()
    _write_npz(directory, leaves, "{'bucket_offsets', 'levels', 'sorted_embeddings', 'sorted_ids'}")
    meta = dict(
        format=2,
        arities=list(index.arities), depth=index.depth,
        model_type=index.model_type,
        n_sections=n_sections, cutoff=cutoff,
        n_objects=index.n_objects, n_leaves=index.n_leaves,
        max_bucket_size=index.max_bucket_size,
        store_dtype=store_dtype, beam_width=beam_width,
        node_eval=node_eval, seed=seed,
        **extra_meta,
    )
    if scale_granularity != "row":
        meta["scale_granularity"] = scale_granularity
    if compute_dtype != "float32":
        meta["compute_dtype"] = compute_dtype
    if beam_widths is not None:
        meta["beam_widths"] = [int(b) for b in beam_widths]
    if temperatures is not None:
        meta["temperatures"] = [float(t) for t in temperatures]
    if prebuilt_planes:
        planes = planes_lib.from_lmi(index, temperatures)
        leaves = {}
        for i, pl in enumerate(planes.levels):
            for kind in ("mats", "vecs"):
                for m, t in enumerate(getattr(pl, kind)):
                    leaves[_planes_key(i, kind, m)] = t.detach().cpu().numpy()
        _write_npz(os.path.join(directory, "planes"), leaves,
                   "{'levels': (" + ", ".join("Planes" for _ in planes.levels) + ")}")
        meta["prebuilt_planes"] = dict(revision=planes.revision,
                                       temperatures=[float(t) for t in planes.temperatures])
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_meta(directory: str) -> dict:
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)


def serving_defaults(meta: dict) -> dict:
    """Serving knobs of a meta.json with the JAX package's legacy rules: a
    ``beam_widths`` schedule wins over the scalar ``beam_width`` (<= 0
    means exact); missing keys mean exact enumeration, temperature 1.0,
    gather node evaluation, a float32 store, row scales, f32 compute."""
    schedule = meta.get("beam_widths")
    if schedule:
        beam = tuple(int(b) for b in schedule)
    else:
        beam = meta.get("beam_width")
        if beam is not None and beam <= 0:
            beam = None
    temps = meta.get("temperatures")
    return dict(
        store_dtype=meta.get("store_dtype") or "float32",
        beam=beam,
        node_eval=meta.get("node_eval") or "gather",
        temperatures=tuple(float(t) for t in temps) if temps else None,
        scale_granularity=meta.get("scale_granularity") or "row",
        compute_dtype=meta.get("compute_dtype") or "float32",
    )


def load_index(directory: str, device=None) -> LMI:
    """Load an index directory (format 2, or legacy format 1) onto
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    meta = load_meta(directory)
    arities = tuple(int(a) for a in meta["arities"])
    model_type = meta["model_type"]
    dim = meta["n_sections"] * (meta["n_sections"] - 1) // 2
    n = meta["n_objects"]
    with np.load(os.path.join(directory, "step_0.npz"), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__treedef__"}

    def get(key, shape):
        if key not in arrays:
            raise KeyError(f"checkpoint in {directory} is missing leaf {key}")
        a = arrays[key]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"leaf {key}: checkpoint {a.shape} vs expected {tuple(shape)}")
        return a

    if meta.get("format", 1) >= 2:
        roots = [("levels", i) for i in range(len(arities))]
    else:  # legacy 2-level checkpoints
        roots = [("l1_params",), ("l2_params",)]
    levels = []
    for i, root in enumerate(roots):
        lead = (math.prod(arities[:i]),) if i else ()
        shapes = {
            "kmeans": {"centroids": (*lead, arities[i], dim)},
            "gmm": {"means": (*lead, arities[i], dim), "variances": (*lead, arities[i], dim),
                    "log_weights": (*lead, arities[i])},
            "kmeans+logreg": {"w": (*lead, dim, arities[i]), "b": (*lead, arities[i])},
        }[model_type]
        levels.append({name: get(_key(*root, name), shp) for name, shp in shapes.items()})
    offsets = get(_key("bucket_offsets"), (math.prod(arities) + 1,))
    return index_from_numpy(
        levels, offsets, get(_key("sorted_ids"), (n,)),
        get(_key("sorted_embeddings"), (n, dim)),
        arities=arities, model_type=model_type,
        max_bucket_size=int(meta.get("max_bucket_size") or 0), device=dev,
    )


def load_planes(directory: str, index: LMI):
    """The prebuilt node planes saved beside an index, on the index's
    device, or None when the meta has no ``prebuilt_planes`` key (built
    without them: the segmented beam then canonicalizes per batch). The
    revision and temperatures recorded in the meta come back with them, so
    `core.planes.validate` can reject them for a changed index or another
    serving schedule."""
    info = load_meta(directory).get("prebuilt_planes")
    if not info:
        return None
    n_mats, n_vecs, _raw = _FAMILY_SHAPES[index.model_type]
    path = os.path.join(directory, "planes", "step_0.npz")
    levels = []
    with np.load(path, allow_pickle=False) as z:
        for i in range(1, index.depth):
            lead = (math.prod(index.arities[:i]), index.arities[i])
            tensors = {}
            for kind, n, shape in (("mats", n_mats, (*lead, index.dim)), ("vecs", n_vecs, lead)):
                for m in range(n):
                    key = _planes_key(i - 1, kind, m)
                    if key not in z.files:
                        raise KeyError(f"planes checkpoint {path} is missing leaf {key}")
                    a = z[key]
                    if tuple(a.shape) != shape:
                        raise ValueError(f"planes leaf {key}: {a.shape} vs expected {shape}")
                    tensors.setdefault(kind, []).append(
                        torch.tensor(np.asarray(a, np.float32), device=index.device))
            levels.append(Planes(mats=tuple(tensors["mats"]), vecs=tuple(tensors["vecs"])))
    return planes_lib.IndexPlanes(
        temperatures=tuple(float(t) for t in info["temperatures"]),
        levels=tuple(levels), revision=int(info["revision"]))
