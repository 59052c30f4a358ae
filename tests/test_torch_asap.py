"""Port parity of ASAP pooling and ASAPGCN (wsi_hgnn_tpu_torch/models/
asap.py, config.py) and the MLP baselines against the JAX package on the
CPU: the same numpy graphs and the same flax variables in both packages;
the forward to 1e-4, the selected top-K permutation exactly, every
parameter's gradient to 1e-4 relative."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu.models import mlp as jax_mlp
from wsi_hgnn_tpu.models.asap import ASAPPooling as JaxASAPPooling
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import parse_gnn_model
from wsi_hgnn_tpu_torch.graph import batch_graphs, from_arrays
from wsi_hgnn_tpu_torch.models import (ASAPGCN, ASAPPooling, MLP2Layers,
                                       MLP4Layers)

from test_torch_zoo import assert_tree_close, flat, jax_graph
from test_torch_zoo_train import _dropout_with
import port_threads  # noqa: F401  (torch threads per test worker)

F_DIM, CPU = 5, torch.device("cpu")


def make_graph(rng, n, node_capacity=None, edge_capacity=None):
    """A random directed graph of n nodes and 2n distinct non-self edges,
    padded (the JAX package's test_asap.make_graph)."""
    x = rng.randn(n, F_DIM).astype(np.float32)
    edges = set()
    while len(edges) < 2 * n:
        s, d = rng.randint(0, n, 2)
        if s != d:
            edges.add((int(s), int(d)))
    src, dst = (np.asarray(e, np.int32) for e in zip(*sorted(edges)))
    return from_arrays(x, src, dst, n_node_types=1,
                       node_capacity=node_capacity,
                       edge_capacity=edge_capacity)


def pooling_pair(k, g, seed):
    """(jax module, port module, flax params) on the port's seeded
    flax-like weights."""
    tm = ASAPPooling(F_DIM, k)
    params = convert.to_flax_variables(convert.init_flax_like_(tm, seed))
    return JaxASAPPooling(in_dim=F_DIM, k=k), tm, params["params"]


def run_both(k, g, seed=0):
    jm, tm, params = pooling_pair(k, g, seed)
    g_j = jax_graph(g)
    want = [np.asarray(a) for a in jax.jit(
        lambda p: jm.apply({"params": p}, g_j))(params)]
    with torch.no_grad():
        got = [a.numpy() for a in tm(g.to_torch(CPU))]
    return got, want, (jm, tm, params)


NAMES = ("pooled", "adj", "cluster_mask", "perm", "fitness")


def assert_pooling_equal(got, want):
    for name, a, b in zip(NAMES, got, want):
        if name in ("cluster_mask", "perm"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("n,k,caps", [(7, 3, (16, 64)), (9, 4, (None, None)),
                                      (3, 5, (None, None))])
def test_pooling_forward_matches_jax(n, k, caps):
    """Pooled features, adjacency and fitness to 1e-4; the top-K
    permutation and cluster mask exactly. n=3 < K=5: the excess clusters
    are invalid, their rows and columns 0."""
    g = make_graph(np.random.RandomState(n), n, *caps)
    got, want, _ = run_both(k, g, seed=n)
    assert_pooling_equal(got, want)
    pooled, adj, cmask = got[:3]
    assert int(cmask.sum()) == min(n, k)
    dead = ~cmask[0]
    assert not pooled[0][dead].any()
    assert not adj[0][dead].any() and not adj[0][:, dead].any()


def test_pooling_ties_keep_the_lower_index():
    """Equal fitness everywhere (zero weights): the top-K picks the K
    lowest node ids in order, as lax.top_k does."""
    g = make_graph(np.random.RandomState(2), 8)
    jm, tm, params = pooling_pair(4, g, 0)
    params = jax.tree.map(np.zeros_like, params)
    convert.load_flax_variables(tm, {"params": params})
    want = jm.apply({"params": params}, jax_graph(g))[3]
    with torch.no_grad():
        got = tm(g.to_torch(CPU))[3]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 2, 3]])


@pytest.mark.parametrize("sizes,k,seed", [((7, 9), 4, 7), ((9, 3), 5, 13)])
def test_pooling_batched_matches_per_graph(sizes, k, seed):
    """Two graphs pooled in one batch equal each pooled alone, in the port
    and against JAX (the JAX package's own two cases); a small graph's
    invalid slots (which tie onto the other graph's nodes) leave the big
    graph's valid centres' columns intact."""
    rng = np.random.RandomState(seed)
    graphs = [make_graph(rng, n) for n in sizes]
    gb = batch_graphs(graphs, node_capacity=32, edge_capacity=128)
    got, want, (_, tm, _) = run_both(k, gb, seed=1)
    assert_pooling_equal(got, want)
    for gi, g in enumerate(graphs):
        gs = batch_graphs([g], node_capacity=32, edge_capacity=128)
        with torch.no_grad():
            alone = [a.numpy() for a in tm(gs.to_torch(CPU))]
        np.testing.assert_allclose(got[0][gi], alone[0][0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[1][gi], alone[1][0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[2][gi], alone[2][0])
    if sizes[1] < k:  # a dropped S column would leave only the diagonal
        assert np.all(got[1][0].sum(1) - 1.0 > 1e-6)


def test_pooling_gradients_match_jax():
    """Every parameter's gradient of a fixed linear function of the pooled
    features and adjacency to 1e-4 relative (scores enter S^T A S with
    no gradient in both)."""
    rng = np.random.RandomState(5)
    gb = batch_graphs([make_graph(rng, 8), make_graph(rng, 6)],
                      node_capacity=16, edge_capacity=64)
    k = 3
    jm, tm, params = pooling_pair(k, gb, 4)
    c1 = np.linspace(-1, 1, 2 * k * F_DIM, dtype=np.float32).reshape(
        2, k, F_DIM)
    c2 = np.linspace(1, -1, 2 * k * k, dtype=np.float32).reshape(2, k, k)
    g_j = jax_graph(gb)

    def loss(p):
        pooled, adj, *_ = jm.apply({"params": p}, g_j)
        return (pooled * c1).sum() + (adj * c2).sum()

    want = flat(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    tm.zero_grad(set_to_none=True)
    pooled, adj, *_ = tm(gb.to_torch(CPU))
    ((pooled * torch.from_numpy(c1)).sum()
     + (adj * torch.from_numpy(c2)).sum()).backward()
    got = flat(convert.params_to_flax(tm, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in tm.named_parameters()}))
    assert_tree_close(got, want, rtol=1e-4)
    assert all(np.abs(v).max() > 0 for v in want.values())


def _asap_section(k=4, hidden=8, layers=2, drop=0.0):
    return {"name": "GCN", "num_layers": layers, "in_dim": F_DIM,
            "hidden_dim": hidden, "out_dim": 3, "feat_drop": drop,
            "graph_pooling_type": "asap", "pool_k": k}


def test_asapgcn_forward_and_gradients_match_jax():
    """ASAPGCN from the factory on both sides: eval logits to 1e-4 and the
    gradient of a fixed linear function of the training-mode logits (the
    dropout masks JAX drew, replayed) to 1e-4 relative, on a batch of a
    graph with fewer nodes than K and one with more, self-loops as loaded."""
    from wsi_hgnn_tpu_torch.models import DropSource

    section = _asap_section(drop=0.3, layers=3)
    jm, hetero = jax_parse_gnn_model(section)
    tm, hetero_t = parse_gnn_model(section)
    assert isinstance(tm, ASAPGCN) and not hetero and not hetero_t
    rng = np.random.RandomState(9)
    graphs = []
    for n in (3, 11):
        g = make_graph(rng, n)
        graphs.append(from_arrays(
            np.asarray(g.feat)[:n], np.asarray(g.src)[:2 * n],
            np.asarray(g.dst)[:2 * n], add_self_loops=True))
    gb = batch_graphs(graphs, node_capacity=16, edge_capacity=64)
    g_j, g_t = jax_graph(gb), gb.to_torch(CPU)
    variables = convert.to_flax_variables(convert.init_flax_like_(tm, 3))

    want = np.asarray(jax.jit(lambda v: jm.apply(v, g_j, train=False))(
        variables))
    tm.eval()
    with torch.no_grad():
        got = tm(g_t).numpy()
    assert got.shape == (2, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    # both packages drop out with the same numpy keep-masks
    mrng = np.random.RandomState(4)
    masks = []

    def take(shape, rate):
        masks.append(mrng.uniform(size=shape) >= rate)
        return jnp.asarray(masks[-1])

    coef = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3)

    def loss(params):
        out = jm.apply(dict(variables, params=params), g_j, train=True)
        return (out * coef).sum()

    with _dropout_with(take):
        want_g = flat(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            variables["params"])))
    assert len(masks) == 2
    tm.train()
    tm.zero_grad(set_to_none=True)
    drops = DropSource(masks=[torch.from_numpy(m) for m in masks])
    (tm(g_t, drops) * torch.from_numpy(coef)).sum().backward()
    assert len(drops.used) == 2
    got_g = flat(convert.params_to_flax(tm, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in tm.named_parameters()}))
    assert_tree_close(got_g, want_g, rtol=1e-4)


@pytest.mark.parametrize("cls,jcls", [(MLP2Layers, jax_mlp.MLP2Layers),
                                      (MLP4Layers, jax_mlp.MLP4Layers)])
def test_mlp_baselines_match_jax(cls, jcls):
    """The MLP baselines' parameter trees equal flax's, and their outputs
    agree to 1e-5 on the same weights."""
    x = np.random.RandomState(0).randn(6, 12).astype(np.float32)
    jm = jcls(hidden_dim=16, out_dim=3)
    want_vars = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)))
    tm = cls(12, 16, 3)
    convert.load_flax_variables(tm, want_vars)
    assert ({k: v.shape for k, v in flat(convert.to_flax_variables(tm)).items()}
            == {k: v.shape for k, v in flat(want_vars).items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(want_vars, x)),
                               rtol=1e-5, atol=1e-5)
