"""Port parity: one slide's padded KNN edge list (graph/build.py::
build_edges_device), the KNN edge list (ops/knn.py::knn_edges) and graph
construction with `knn_impl: approx`, against the JAX package on the
same numpy inputs, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.graph.build import build_edges_device as jax_edges
from wsi_hgnn_tpu.ops.knn import knn_edges as jax_knn_edges
from wsi_hgnn_tpu.pipeline.construct import GraphConstructor as JaxConstructor
from wsi_hgnn_tpu_torch import graph as tgraph
from wsi_hgnn_tpu_torch.ops import knn as tknn
from wsi_hgnn_tpu_torch.pipeline.construct import GraphConstructor
import port_threads  # noqa: F401  (torch threads per test worker)


def _assert_edges_equal(got, want):
    """(src, dst, esign, sim, edge_mask): indices and masks exactly, sim to
    1e-5 (a Pearson r summed in another order)."""
    names = ("src", "dst", "esign", "sim", "edge_mask")
    want = jax.device_get(want)
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        assert g.shape == np.asarray(w).shape, name
        if name == "sim":
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
            if name != "edge_mask":
                assert g.dtype == np.int32, name


@pytest.mark.parametrize("n, with_mask, impl", [
    (300, True, "exact"), (300, False, "exact"), (300, True, "approx"),
    (300, False, "approx"), (4096, True, "exact")])
def test_build_edges_device_matches_jax(n, with_mask, impl):
    """The dense route (the gram's Pearson) with and without a padding
    mask, for the exact and approx KNN, and the streaming one at
    STREAM_THRESHOLD (pearson_sim_at; approx's streaming KNN is
    tests/test_torch_knn.py's)."""
    radius, d = 9, 16
    assert (n >= tknn.STREAM_THRESHOLD) == (n == 4096)
    rng = np.random.RandomState(30 + n)
    f = rng.randn(n, d).astype(np.float32)
    mask = (np.arange(n) < n - n // 10) if with_mask else None
    got = tgraph.build_edges_device(
        torch.from_numpy(f), radius,
        None if mask is None else torch.from_numpy(mask), knn_impl=impl)
    want = jax_edges(jnp.asarray(f), radius,
                     None if mask is None else jnp.asarray(mask),
                     knn_impl=impl)
    _assert_edges_equal(got, want)
    assert got[4].sum() > 0


@pytest.mark.parametrize("impl", ["exact", "approx", "pallas"])
def test_build_edges_device_tiny_slide_matches_jax(impl):
    """A 64-slot slide with 5 live nodes and k = 8: every row runs out of
    live candidates. JAX's approx fills the rest of a row with masked
    candidates in its own order, which the edge mask drops; so the mask,
    and dst where it holds, equal JAX's for every impl."""
    n, radius = 64, 9
    rng = np.random.RandomState(31)
    f = rng.randn(n, 8).astype(np.float32)
    mask = np.arange(n) < 5
    src, dst, esign, sim, emask = tgraph.build_edges_device(
        torch.from_numpy(f), radius, torch.from_numpy(mask), knn_impl=impl)
    j_src, j_dst, _, j_sim, j_emask = jax.device_get(jax_edges(
        jnp.asarray(f), radius, jnp.asarray(mask),
        knn_impl="exact" if impl == "pallas" else impl))
    keep = emask.numpy()
    np.testing.assert_array_equal(keep, j_emask)
    assert keep.sum() == 5 * 4          # each live node to the 4 others
    np.testing.assert_array_equal(dst.numpy()[keep], j_dst[keep])
    np.testing.assert_array_equal(src.numpy()[keep], j_src[keep])
    np.testing.assert_allclose(sim.numpy()[keep], j_sim[keep], atol=1e-5)
    assert not src.numpy()[~keep].any() and not dst.numpy()[~keep].any()
    assert not sim.numpy()[~keep].any() and not esign.numpy()[~keep].any()


def test_knn_edges_matches_jax():
    n, k = 200, 6
    rng = np.random.RandomState(32)
    f = rng.randn(n, 12).astype(np.float32)
    mask = np.arange(n) < 180
    for m in (mask, None):
        src, dst = tknn.knn_edges(torch.from_numpy(f), k,
                                  None if m is None else torch.from_numpy(m))
        j_src, j_dst = jax_knn_edges(jnp.asarray(f), k,
                                     None if m is None else jnp.asarray(m))
        assert src.dtype == dst.dtype == torch.int32
        assert src.shape == dst.shape == (n * k,)
        np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
        np.testing.assert_array_equal(dst.numpy(), np.asarray(j_dst))


def test_construction_with_knn_impl_approx_matches_jax(tmp_path, monkeypatch):
    """A construction config that sets `knn_impl: approx` reaches the KNN
    as 'approx' and builds JAX's graph (precomputed features: no CNN)."""
    n = 120
    rng = np.random.RandomState(33)
    prefix = str(tmp_path / "slide")
    np.savez(prefix + ".features.npz",
             features=rng.randn(n, 24).astype(np.float32),
             node_types=rng.randint(0, 6, n).astype(np.int32))
    cfg = {"radius": 9, "encoder_name": "precomputed", "knn_impl": "approx",
           "n_node_type": 6}
    seen = []
    real = tknn.knn_lookup

    def recording(*args, impl="exact", **kw):
        seen.append(impl)
        return real(*args, impl=impl, **kw)

    monkeypatch.setattr(tknn, "knn_lookup", recording)
    het, homo, types = GraphConstructor(dict(cfg), {}, {}, prefix,
                                        device="cpu").construct_graph()
    assert seen == ["approx"]
    j_het, _, j_types = JaxConstructor(dict(cfg), {}, {},
                                       prefix).construct_graph()
    np.testing.assert_array_equal(types, j_types)
    e = int(np.asarray(j_het.edge_mask).sum())
    assert int(np.asarray(het.edge_mask).sum()) == e == n * 8
    for name in ("src", "dst", "esign"):
        np.testing.assert_array_equal(np.asarray(getattr(het, name))[:e],
                                      np.asarray(getattr(j_het, name))[:e])
    np.testing.assert_allclose(np.asarray(het.sim)[:e],
                               np.asarray(j_het.sim)[:e], atol=1e-5)
