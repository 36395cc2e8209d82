"""The port's index I/O against the JAX package's: the parity seam every
other port test stands on. Indexes cross both ways through the format-2
on-disk layout and in memory through `index_from_numpy`."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import checkpoint as ckpt
from repro.launch import build_index as jbuild
from repro_torch import index_io
from torch_parity import FAMILIES, np_, random_jax_index, to_port

REPO = Path(__file__).resolve().parents[1]


def _assert_same(port_index, jax_index):
    assert port_index.arities == tuple(jax_index.arities)
    assert port_index.model_type == jax_index.model_type
    assert port_index.max_bucket_size == jax_index.max_bucket_size
    assert len(port_index.levels) == len(jax_index.levels)
    for pl, jl in zip(port_index.levels, jax_index.levels):
        assert set(pl) == set(jl)
        for k in jl:
            np.testing.assert_array_equal(np_(pl[k]), np.asarray(jl[k]))
    for name in ("bucket_offsets", "sorted_ids", "sorted_embeddings"):
        a, b = np_(getattr(port_index, name)), np.asarray(getattr(jax_index, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_save_port_load(tmp_path, family):
    jidx = random_jax_index(0, family, (4, 4, 4), d=45)
    jbuild.save_index(str(tmp_path), jidx, n_sections=10, cutoff=50.0)
    _assert_same(index_io.load_index(str(tmp_path), device="cpu"), jidx)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_save_jax_load(tmp_path, family):
    jidx = random_jax_index(1, family, (8, 8), d=45)
    pidx = to_port(jidx)
    index_io.save_index(str(tmp_path), pidx, n_sections=10, cutoff=50.0,
                        store_dtype="bfloat16", seed=3)
    _assert_same(pidx, jbuild.load_index(str(tmp_path)))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["format"] == 2 and meta["store_dtype"] == "bfloat16" and meta["seed"] == 3
    # the JAX package's serving-default rules read the port's meta alike
    assert index_io.serving_defaults(meta) == jbuild.serving_defaults(meta)


def test_index_from_numpy_in_memory(small_lmi):
    _assert_same(to_port(small_lmi), small_lmi)


def test_legacy_format1_checkpoint(tmp_path, small_lmi):
    """Format-1 checkpoints keep the 2-level stack under l1/l2_params."""
    state = {"l1_params": small_lmi.levels[0], "l2_params": small_lmi.levels[1],
             "bucket_offsets": small_lmi.bucket_offsets, "sorted_ids": small_lmi.sorted_ids,
             "sorted_embeddings": small_lmi.sorted_embeddings}
    ckpt.save(str(tmp_path), 0, state)
    meta = dict(arities=list(small_lmi.arities), model_type="kmeans", n_sections=10,
                cutoff=50.0, n_objects=small_lmi.n_objects)  # no format, no max_bucket_size
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    _assert_same(index_io.load_index(str(tmp_path), device="cpu"), small_lmi)
    _assert_same(index_io.load_index(str(tmp_path), device="cpu"),
                 jbuild.load_index(str(tmp_path)))


@pytest.mark.parametrize("meta", [
    {},
    {"beam_width": 0, "store_dtype": "bfloat16"},
    {"beam_width": 16, "node_eval": "segmented"},
    {"beam_widths": [8, 4], "beam_width": 16, "temperatures": [1.0, 0.5, 0.7]},
    {"scale_granularity": "bucket", "compute_dtype": "int8", "store_dtype": "int8"},
])
def test_serving_defaults_match_jax(meta):
    assert index_io.serving_defaults(meta) == jbuild.serving_defaults(meta)


def test_load_rejects_mismatched_leaf(tmp_path, small_lmi):
    jbuild.save_index(str(tmp_path), small_lmi, n_sections=10, cutoff=50.0)
    meta = json.loads((tmp_path / "meta.json").read_text())
    meta["n_objects"] += 1
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="sorted_ids"):
        index_io.load_index(str(tmp_path), device="cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, bad


def test_entry_points_default_to_cuda(tmp_path, small_lmi):
    """Without a device argument the entry points run on the card, so on a
    machine without one they raise instead of quietly using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.core import lmi
    from repro_torch.core.embedding import EmbeddingConfig, embed_dataset
    from repro_torch.models import transformer

    jbuild.save_index(str(tmp_path), small_lmi, n_sections=10, cutoff=50.0)
    x = np.array(small_lmi.sorted_embeddings)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_io.load_index(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lmi.build(0, torch.from_numpy(x), arities=(4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        embed_dataset(np.zeros((2, 16, 3), np.float32), np.array([16, 8]), EmbeddingConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_io.index_from_numpy(
            [{k: np.asarray(v) for k, v in lv.items()} for lv in small_lmi.levels],
            np.asarray(small_lmi.bucket_offsets), np.asarray(small_lmi.sorted_ids), x,
            arities=small_lmi.arities, model_type="kmeans")
    lm = stablelm_1_6b.make_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(0, lm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(lm, 2, 16)
