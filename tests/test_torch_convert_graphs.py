"""The port's reference-graph converter (wsi_hgnn_tpu_torch/tools/
convert_reference_graphs.py) against the JAX package's tool
(tools/convert_reference_graphs.py) on the CPU, on
tests/test_convert_reference.py's stand-ins for DGL graphs (no `dgl`
here: the converters read only the graph objects' accessors). The arrays
each tool extracts are equal, and the `.npz` files the port writes hold
the arrays the JAX tool's files hold."""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import port_threads  # noqa: F401  (torch threads per test worker)
from test_convert_reference import FakeHeteroGraph, FakeHomoGraph

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import convert_reference_graphs as jax_tool  # noqa: E402

from wsi_hgnn_tpu.data import save_graph_npz as jax_save  # noqa: E402
from wsi_hgnn_tpu_torch.tools import convert_reference_graphs as tool  # noqa: E402


def hetero_graph(seed=0):
    """tests/test_convert_reference.py's heterograph: 3 of 6 node types
    populated under unsorted names, one empty relation."""
    rng = np.random.RandomState(seed)
    feats = {"2": rng.randn(3, 16).astype(np.float32),
             "0": rng.randn(2, 16).astype(np.float32),
             "5": rng.randn(1, 16).astype(np.float32)}
    edges = {("0", "pos", "2"): (np.array([0, 1]), np.array([1, 2])),
             ("2", "neg", "0"): (np.array([0]), np.array([1])),
             ("2", "pos", "5"): (np.array([2]), np.array([0])),
             ("5", "neg", "5"): (np.array([], np.int64),
                                 np.array([], np.int64))}
    sims = {("0", "pos", "2"): np.array([0.5, 0.25], np.float32),
            ("2", "neg", "0"): np.array([-0.75], np.float32)}
    return FakeHeteroGraph(feats, edges, sims)


def homo_graph(seed=1):
    rng = np.random.RandomState(seed)
    return FakeHomoGraph(rng.randn(4, 8).astype(np.float32),
                         src=np.array([0, 1, 2]), dst=np.array([1, 2, 3]),
                         etype_ids=np.array([1, 0, 1], np.int64),
                         sim=np.array([0.5, -0.5, 0.25], np.float32))


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] is None or isinstance(want[k], bool):
            assert got[k] is want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["hetero", "homo"])
def test_extracted_arrays_equal_the_jax_tool(kind):
    """convert_hetero / convert_homo give the JAX tool's arrays (a
    relation without `sim` data gets sim 1)."""
    if kind == "hetero":
        g = hetero_graph()
        assert_same(tool.convert_hetero(g), jax_tool.convert_hetero(g))
    else:
        g = homo_graph()
        assert_same(tool.convert_homo(g), jax_tool.convert_homo(g))


def test_written_npz_equal_the_jax_tool(tmp_path):
    """convert_dir over a reference out_dir of pickled graphs writes
    `<kind>/<slide>.npz` files holding what the JAX tool's conversion
    saves through the JAX package's save_graph_npz."""
    src = tmp_path / "ref"
    for kind, graphs in (("heterogeneous", [hetero_graph(0), hetero_graph(3)]),
                         ("homogeneous", [homo_graph(1)])):
        (src / kind).mkdir(parents=True)
        for i, g in enumerate(graphs):
            with open(src / kind / f"TCGA-{i:02d}.pkl", "wb") as f:
                pickle.dump(g, f)
    assert tool.convert_dir(str(src), str(tmp_path / "out")) == 3
    for kind, conv in (("heterogeneous", jax_tool.convert_hetero),
                       ("homogeneous", jax_tool.convert_homo)):
        for p in sorted((src / kind).glob("*.pkl")):
            with open(p, "rb") as f:
                want_file = tmp_path / "want.npz"
                jax_save(str(want_file), **conv(pickle.load(f)))
            got = np.load(tmp_path / "out" / kind / (p.stem + ".npz"))
            want = np.load(want_file)
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_entry_point_needs_dgl(tmp_path):
    """Without `dgl` the `-m` entry exits with the JAX tool's message."""
    out = subprocess.run(
        [sys.executable, "-m", "wsi_hgnn_tpu_torch.tools.convert_reference_"
         "graphs", "--in-dir", str(tmp_path), "--out-dir",
         str(tmp_path / "o")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 1
    assert "needs the `dgl` package" in out.stderr
