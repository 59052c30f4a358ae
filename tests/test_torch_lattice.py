"""Port parity: lattice HEAT models and the typed linears
(wsi_hgnn_tpu_torch/models/lattice.py, models/layers.py, graph/ops.py,
config.py) against the JAX package on JAX-initialised weights, on the
CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.config import parse_lattice_twin as jax_twin
from wsi_hgnn_tpu.graph import ops as jops
from wsi_hgnn_tpu.graph.typed_graph import bucket_size as jax_bucket_size
from wsi_hgnn_tpu.models import lattice as jlat
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import parse_lattice_twin
from wsi_hgnn_tpu_torch.graph import ops as tops
from wsi_hgnn_tpu_torch.graph.typed_graph import bucket_size
from wsi_hgnn_tpu_torch.models import lattice as tlat
import port_threads  # noqa: F401  (torch threads per test worker)

B, N, D, T, R = 2, 64, 16, 6, 5
CLASSES = {"heat2": (jlat.HEATNet2Lattice, tlat.HEATNet2Lattice),
           "heat4": (jlat.HEATNet4Lattice, tlat.HEATNet4Lattice)}


def _graphs(seed, types_mod=None):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, D).astype(np.float32)
    ntypes = rng.randint(0, T, (B, N)).astype(np.int32)
    if types_mod:
        ntypes[0] %= types_mod  # slide 0 misses some node types
    mask = np.arange(N)[None, :] < np.array([N, N - 10])[:, None]
    g_j = jlat.build_lattice_device(jnp.asarray(feats), jnp.asarray(ntypes),
                                    jnp.asarray(mask), R, T)
    g_t = tlat.build_lattice_device(torch.from_numpy(feats),
                                    torch.from_numpy(ntypes),
                                    torch.from_numpy(mask), R, T)
    return g_j, g_t


def _pair(which, presence, seed=0, n_layers=2, **kw):
    g_j, g_t = _graphs(seed, types_mod=2)
    kw = dict(in_dim=D, hidden_dim=32, out_dim=3, n_layers=n_layers,
              n_heads=2, n_node_types=T, dropout=0.0, presence=presence, **kw)
    jcls, tcls = CLASSES[which]
    jm = jcls(**kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), g_j))
    tm = convert.load_flax_variables(tcls(**kw), params).eval()
    return jm, tm, params, g_j, g_t


@pytest.mark.parametrize("which", ["heat2", "heat4"])
@pytest.mark.parametrize("presence", ["graph", "batch"])
@pytest.mark.parametrize("pooling", ["mean", "sum", "max"])
def test_lattice_model_matches_jax(which, presence, pooling):
    jm, tm, params, g_j, g_t = _pair(which, presence,
                                     graph_pooling_type=pooling)
    want = np.asarray(jm.apply(params, g_j, train=False))
    with torch.no_grad():
        got = tm(g_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("presence", ["graph", "batch"])
def test_lattice_softmax_large_logits_matches_jax(presence):
    """Logits far past the +-60 clamp take the per-destination shift (the
    JAX package's lax.cond branch, a device-side select here); small
    logits take the unshifted branch. Both agree with JAX at 1e-4."""
    jm, tm, params, g_j, g_t = _pair("heat4", presence, seed=2, n_layers=1)

    def scale(tree, factor):
        def f(path, leaf):
            keys = "/".join(str(p.key) for p in path if hasattr(p, "key"))
            return leaf * factor if ("k_linears" in keys
                                     or "q_linears" in keys) else leaf
        return jax.tree_util.tree_map_with_path(f, tree)

    for factor in (6.0, 1.0):
        big = scale(params, factor)
        want = np.asarray(jm.apply(big, g_j, train=False))
        convert.load_flax_variables(tm, big)
        with torch.no_grad():
            got = tm(g_t).numpy()
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_graph_presence_is_grouping_invariant():
    _, tm, _, _, g_t = _pair("heat4", "graph")
    solo = tlat.LatticeGraph(*[a[:1] for a in g_t])
    with torch.no_grad():
        np.testing.assert_allclose(tm(g_t)[0].numpy(), tm(solo)[0].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_typed_linears_match_jax():
    rng = np.random.RandomState(7)
    feat = rng.randn(40, 8).astype(np.float32)
    nt = rng.randint(0, 5, 40).astype(np.int32)  # type 5 stays empty
    w = rng.randn(6, 8, 4).astype(np.float32)
    b = rng.randn(6, 4).astype(np.float32)
    want = np.asarray(jops.typed_linear_ragged(*map(jnp.asarray, (feat, nt, w, b))))
    args = [torch.from_numpy(a) for a in (feat, nt, w, b)]
    for got in (tops.typed_linear(*args), tops.typed_linear_ragged(*args)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ts = tops.make_type_sort(args[1], 6)
    js = jops.make_type_sort(jnp.asarray(nt), 6)
    np.testing.assert_array_equal(ts.perm.numpy(), np.asarray(js.perm))
    np.testing.assert_array_equal(ts.group_sizes.numpy(),
                                  np.asarray(js.group_sizes))


def test_parse_lattice_twin_and_bucket_size_match_jax():
    base = dict(name="HEAT4", n_node_types=6, num_layers=2, in_dim=8,
                hidden_dim=16, out_dim=2, n_heads=2, feat_drop=0.0,
                graph_pooling_type="max")
    for cfg in (base, dict(base, name="HEAT2"), dict(base, name="GCN"),
                dict(base, graph_pooling_type="att")):
        j, t = jax_twin(cfg), parse_lattice_twin(cfg)
        assert (j is None) == (t is None)
        if t is not None:
            assert type(t).__name__ == type(j).__name__
            assert t.graph_pooling_type == j.graph_pooling_type
            assert t.typed_impl == j.typed_impl
    for n in (1, 255, 256, 257, 300, 384, 385, 1000, 2048, 2049, 5000):
        assert bucket_size(n) == jax_bucket_size(n)
