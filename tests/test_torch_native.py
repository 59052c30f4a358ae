"""The port's native host packer (wsi_hgnn_tpu_torch/native/, built with
g++ into build/native/) against its numpy path and the JAX package's
batching: bit-equal batches and edge sorts, the capacity and range
errors, and the shape checks made before any pointer reaches C++."""
import numpy as np
import pytest

from wsi_hgnn_tpu.graph import batch_graphs as jax_batch_graphs
from wsi_hgnn_tpu.graph import from_arrays as jax_from_arrays
from wsi_hgnn_tpu.graph.batch import sort_graph_edges as jax_sort
from wsi_hgnn_tpu_torch import native
from wsi_hgnn_tpu_torch.graph import batch_graphs, from_arrays, sort_graph_edges
import port_threads  # noqa: F401  (torch threads per test worker)

FIELDS = ("feat", "node_type", "node_graph", "node_mask", "src", "dst",
          "esign", "sim", "edge_mask", "edge_weight")


def make(mod, n, e, seed, weighted=False):
    rng = np.random.RandomState(seed)
    g = mod(rng.randn(n, 8).astype(np.float32), rng.randint(0, n, e),
            rng.randint(0, n, e), node_type=rng.randint(0, 6, n),
            esign=rng.randint(0, 2, e), sim=rng.randn(e), n_node_types=6,
            node_capacity=64, edge_capacity=128)
    if weighted:
        g = g.replace(edge_weight=rng.rand(128).astype(np.float32))
    return g


def assert_same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("weighted", [False, True])
def test_native_batch_equals_numpy_and_jax(weighted):
    """pack_batch_native through batch_graphs gives the numpy path's arrays
    bit for bit (dtypes too), and the JAX package's batch; so does the
    native edge sort of the batch."""
    sizes = ((10, 30, 1), (20, 50, 2), (5, 12, 3))
    graphs = [make(from_arrays, *s, weighted=weighted) for s in sizes]
    got = batch_graphs(graphs, node_capacity=64, edge_capacity=128)
    plain = batch_graphs(graphs, node_capacity=64, edge_capacity=128,
                         native=False)
    assert_same(got, plain)
    want = jax_batch_graphs(
        [make(jax_from_arrays, *s, weighted=weighted) for s in sizes],
        node_capacity=64, edge_capacity=128)
    for f in FIELDS:
        if getattr(want, f) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    assert_same(sort_graph_edges(got), sort_graph_edges(got, native=False))
    js = jax_sort(want)
    for f in ("src", "dst", "esign", "sim", "edge_mask"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sort_graph_edges(got), f)),
            np.asarray(getattr(js, f)), err_msg=f)


def test_native_sort_edges_is_the_stable_argsort():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 50, 1000).astype(np.int64)
    perm = native.sort_edges_native(keys, 50)
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    with pytest.raises(ValueError, match="out of range"):
        native.sort_edges_native(np.array([60], np.int64), 50)
    with pytest.raises(ValueError, match="out of range"):
        native.sort_edges_native(np.array([-1], np.int64), 50)


def test_native_pack_capacity_and_shape_errors():
    graphs = [make(from_arrays, 40, 100, 4), make(from_arrays, 40, 100, 5)]
    with pytest.raises(ValueError, match="capacity"):
        batch_graphs(graphs, node_capacity=64, edge_capacity=256)
    n, e = [np.asarray(g.node_mask).sum() for g in graphs], [100, 100]
    arrays = [[np.asarray(getattr(g, f))[:k] for g, k in zip(graphs, ks)]
              for f, ks in (("feat", n), ("node_type", n), ("src", e),
                            ("dst", e), ("esign", e), ("sim", e))]
    with pytest.raises(ValueError, match="capacity"):
        native.pack_batch_native(*arrays, 128, 150)
    arrays[0][1] = arrays[0][1][:, :4]
    with pytest.raises(ValueError, match="feature dim"):
        native.pack_batch_native(*arrays, 128, 256)
    arrays[0][1] = np.asarray(graphs[1].feat)[:n[1]]
    arrays[3][0] = arrays[3][0][:-1]
    with pytest.raises(ValueError, match="inconsistent"):
        native.pack_batch_native(*arrays, 128, 256)


def test_native_library_is_built_in_the_checkout():
    """One library per source and flags, under build/native/."""
    path = native.build()
    assert path == native.lib_path() and path.exists()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.get_lib() is native.get_lib()
