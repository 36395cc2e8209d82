"""The port's two CLIs at a tiny size on ``--device cpu``: build_index
writes an index the JAX package's ``load_index`` reads, and serve answers
from indexes of either package."""
import json
import sys

import numpy as np
import pytest

from repro.launch import build_index as jbuild
from repro_torch.index_io import load_index
from repro_torch.launch import build_index as pbuild, serve as pserve
from torch_parity import np_

TINY = ["--n-proteins", "600", "--n-families", "20", "--arity", "8", "8", "--device", "cpu"]


@pytest.fixture(scope="module")
def port_index_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_index")
    pbuild.main(TINY + ["--store-dtype", "bfloat16", "--out", str(out)])
    return out


def test_build_cli_writes_an_index_jax_loads(port_index_dir):
    jidx = jbuild.load_index(str(port_index_dir))
    pidx = load_index(str(port_index_dir), device="cpu")
    assert jidx.arities == (8, 8) and jidx.n_objects == 600
    np.testing.assert_array_equal(np.asarray(jidx.sorted_ids), np_(pidx.sorted_ids))
    np.testing.assert_array_equal(np.asarray(jidx.levels[1]["centroids"]),
                                  np_(pidx.levels[1]["centroids"]))
    np.testing.assert_array_equal(np.sort(np.asarray(jidx.sorted_ids)), np.arange(600))
    meta = json.loads((port_index_dir / "meta.json").read_text())
    assert jbuild.serving_defaults(meta)["store_dtype"] == "bfloat16"


def test_serve_cli_answers(port_index_dir, capsys):
    answers = pserve.main(["--index", str(port_index_dir), "--n-queries", "40", "--batch", "16",
                           "--k", "10", "--stop", "0.05", "--device", "cpu"])
    out = capsys.readouterr().out
    assert answers.shape == (40, 10) and (answers[:, 0] >= 0).all()
    assert "store dtype bfloat16" in out  # the build's meta.json default
    assert "QPS over 3 batches" in out and "p99=" in out


def test_serve_cli_on_a_jax_built_index(tmp_path, monkeypatch, capsys):
    out = tmp_path / "jax_index"
    monkeypatch.setattr(sys, "argv", ["build_index", "--n-proteins", "400", "--n-families", "10",
                                      "--arity", "4", "4", "--out", str(out)])
    jbuild.main()
    answers = pserve.main(["--index", str(out), "--n-queries", "8", "--batch", "8", "--k", "5",
                           "--stop", "0.1", "--device", "cpu"])
    assert answers.shape == (8, 5) and (answers >= 0).all()
    assert "float32" in capsys.readouterr().out


def test_cli_rejects_what_the_slice_lacks(tmp_path):
    with pytest.raises(ValueError, match="granularity"):
        pbuild.main(TINY + ["--store-dtype", "int8", "--scale-granularity", "tile",
                            "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pbuild.main(TINY + ["--model", "gmm", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="store-dtype"):
        pbuild.main(TINY + ["--store-dtype", "float16", "--out", str(tmp_path)])
