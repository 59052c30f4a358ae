"""Edge sharding in the port (wsi_hgnn_tpu_torch/parallel/big_graph.py,
the group-aware segment primitives of graph/ops.py and typed_graph.py)
against the JAX package on the CPU: one gloo world of 4 processes holds
a two-slide batch's 512 edge slots as four slices of 128, and the full
models' forward, gradients and one training step equal the JAX models'
single-device answers on the same weights (tests/test_big_graph.py's
cases and tolerances)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from wsi_hgnn_tpu import graph as jgraph
from wsi_hgnn_tpu import models as jmodels
from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu.config import parse_loss as jax_parse_loss
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.graph import batch_graphs, from_arrays
from wsi_hgnn_tpu_torch.parallel import shard_edges

import port_threads  # noqa: F401  (torch threads per test worker)
import port_worlds

WORLD = 4

MODELS = {
    "HEAT4": ("HEATNet4", dict(in_dim=16, hidden_dim=32, out_dim=2,
                               n_layers=2, n_heads=4, n_node_types=6,
                               dropout=0.0), True),
    "HEAT2": ("HEATNet2", dict(in_dim=16, hidden_dim=32, out_dim=2,
                               n_layers=2, n_heads=4, n_node_types=6,
                               dropout=0.0), True),
    "HGT": ("HGT", dict(in_dim=16, hidden_dim=32, out_dim=2, n_layers=2,
                        n_heads=4, n_node_types=6), True),
    "GCN": ("GCN", dict(in_dim=16, hidden_dim=32, out_dim=2, n_layers=2,
                        dropout=0.0, graph_pooling_type="mean"), False),
    "GAT": ("GAT", dict(n_layers=2, in_dim=16, hidden_dim=8, out_dim=2,
                        heads=(2, 2, 1), feat_drop=0.0, attn_drop=0.0,
                        negative_slope=0.2, residual=False,
                        graph_pooling_type="mean"), False),
}
GIN_MAX = {"name": "GIN", "in_dim": 16, "hidden_dim": 16, "out_dim": 2,
           "num_layers": 2, "num_mlp_layers": 2, "feat_drop": 0.0,
           "graph_pooling_type": "sum", "neighbor_pooling_type": "max",
           "learn_eps": False}
TRAIN = ("HEAT4", "GCN")


def batched_graph(seed=0, n_graphs=2, n=40, d=16, t=6):
    """tests/test_big_graph.py's batch, by the port's host code: two
    slides in 128 node and 512 edge slots."""
    rng = np.random.RandomState(seed)
    gs = []
    for _ in range(n_graphs):
        nn_ = rng.randint(n - 8, n + 8)
        e = rng.randint(3 * nn_, 5 * nn_)
        gs.append(from_arrays(
            rng.randn(nn_, d).astype(np.float32),
            rng.randint(0, nn_, e), rng.randint(0, nn_, e),
            node_type=rng.randint(0, t, nn_), esign=rng.randint(0, 2, e),
            sim=rng.randn(e), n_node_types=t))
    return batch_graphs(gs, node_capacity=128, edge_capacity=512)


def arrays(g):
    return {f: getattr(g, f) for f in (
        "feat", "node_type", "node_graph", "node_mask", "src", "dst", "esign",
        "sim", "edge_mask", "edge_weight", "n_graphs", "n_node_types",
        "n_edge_types", "edges_sorted")}


def jax_graph(g, hetero=True):
    jg = jgraph.TypedGraph(
        **{k: jnp.asarray(np.asarray(getattr(g, k))) for k in (
            "feat", "node_type", "node_graph", "node_mask", "src", "dst",
            "esign", "sim", "edge_mask")},
        n_graphs=g.n_graphs, n_node_types=g.n_node_types,
        n_edge_types=g.n_edge_types, edges_sorted=g.edges_sorted)
    return jg if hetero else jgraph.to_homogeneous(jg)


def seeded_variables(spec, seed):
    model = port_worlds.port_model(spec)
    return jax.tree.map(np.copy, convert.to_flax_variables(
        convert.init_flax_like_(model, seed)))


def jax_model(spec):
    if isinstance(spec, dict):
        return jax_parse_gnn_model(spec)[0]
    kind, kwargs = spec
    return getattr(jmodels, kind)(**kwargs)


def spec(name):
    kind, kwargs, hetero = MODELS[name]
    return (kind, kwargs), hetero


def _cases():
    cases = []
    g = batched_graph()
    for name in MODELS:
        s, hetero = spec(name)
        cases.append((f"forward/{name}", port_worlds.big_forward, {
            "model": s, "variables": seeded_variables(s, 0),
            "graph": arrays(g), "is_hetero": hetero}))
    g3 = batched_graph(seed=3)
    for name in TRAIN:
        s, hetero = spec(name)
        cases.append((f"train/{name}", port_worlds.big_train_step, {
            "model": s, "variables": seeded_variables(s, 1),
            "graph": arrays(g3), "is_hetero": hetero,
            "labels": np.array([0, 1]), "weights": np.array([1.0, 1.0],
                                                            np.float32)}))
    s, _ = spec("HEAT2")
    cases.append(("augmented", port_worlds.big_train_augmented, {
        "model": s, "variables": seeded_variables(s, 1),
        "graph": arrays(batched_graph(seed=7))}))
    cases.append(("gin_max", port_worlds.big_forward_grads, {
        "model": GIN_MAX, "variables": seeded_variables(GIN_MAX, 0),
        "graph": arrays(batched_graph(seed=13)), "is_hetero": False}))
    s, _ = spec("HEAT4")
    cases.append(("occupancy", port_worlds.big_per_graph_occupancy, {
        "model": s, "variables": seeded_variables(s, 2),
        "graph": arrays(batched_graph(seed=17))}))
    cases.append(("allreduce_rule", port_worlds.allreduce_rule, None))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    results = port_worlds.run_world(port_worlds.run_cases, WORLD,
                                    tmp_path_factory.mktemp("world"), cases)
    return {name: inp for name, _, inp in cases}, results


@pytest.mark.parametrize("name", list(MODELS))
def test_full_model_forward_matches_single_device(world, name):
    inputs, results = world
    inp = inputs[f"forward/{name}"]
    s, hetero = spec(name)
    model = jax_model(s)
    want = np.asarray(jax.jit(lambda v, g: model.apply(v, g, train=False))(
        inp["variables"], jax_graph(batched_graph(), hetero)))
    for rank in range(WORLD):
        np.testing.assert_allclose(results[rank][f"forward/{name}"], want,
                                   rtol=1e-4, atol=1e-5)


def _jax_step(name, inp):
    """The JAX test's single-device reference step: loss, gradients and
    the parameters after optax.sgd(1e-3)."""
    s, hetero = spec(name)
    model = jax_model(s)
    g = jax_graph(batched_graph(seed=3), hetero)
    loss_fcn = jax_parse_loss({"loss": "CE"})
    labels = jnp.asarray(inp["labels"], jnp.int32)
    weights = jnp.asarray(inp["weights"])
    params = jax.tree.map(jnp.asarray, inp["variables"]["params"])

    def loss_fn(p):
        return loss_fcn(model.apply({"params": p}, g, train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)}),
                        labels, weights)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.sgd(1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = jax.tree.map(lambda p, u: p + u, params, updates)
    return float(loss), port_worlds.flat(grads), port_worlds.flat(new)


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_grads_match_single_device(world, name):
    """One edge-sharded step without augmentation: the loss, every
    gradient (relative L2 1e-4) and the parameters after the update (the
    JAX test's rtol 2e-4 / atol 1e-6) equal the single-device step's, on
    every rank. The update is SGD, whose step is linear in the gradient:
    Adam's first step moves every entry by about lr whatever its
    gradient, so entries whose gradient is about 0 would compare f32
    rounding (here a bias entry of HEAT4's last layer, 1e-2 relative)."""
    inputs, results = world
    loss_j, grads_j, params_j = _jax_step(name, inputs[f"train/{name}"])
    for rank in range(WORLD):
        loss, probs, grads, params = results[rank][f"train/{name}"]
        assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
        assert np.all(np.isfinite(probs))
        assert sorted(grads) == sorted(grads_j)
        for k in grads_j:
            den = np.linalg.norm(grads_j[k])
            err = np.linalg.norm(grads[k] - grads_j[k])
            assert err <= 1e-4 * den + 1e-7, (k, err, den)
            np.testing.assert_allclose(params[k], params_j[k], rtol=2e-4,
                                       atol=1e-6, err_msg=k)


def test_train_step_with_augmentation_trains(world):
    """Augmented steps: finite losses, parameters moved, and every rank
    holds the same parameters (the node masks and dropout agree)."""
    inputs, results = world
    start = port_worlds.flat(inputs["augmented"]["variables"]["params"])
    losses, params = results[0]["augmented"]
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert max(float(np.abs(params[k] - start[k]).max()) for k in start) > 0
    for rank in range(1, WORLD):
        other = results[rank]["augmented"]
        assert other[0] == losses
        for k in params:
            np.testing.assert_array_equal(other[1][k], params[k])


def test_shard_edges_requires_divisibility():
    g = batched_graph()
    with pytest.raises(ValueError):
        shard_edges(g, 7)
    sharded = shard_edges(g, 4)
    assert sharded.src.shape == (4, 128) and sharded.feat.shape == (128, 16)


def test_gin_max_pooling_under_edge_sharding(world):
    """GIN with neighbor_pooling_type 'max' runs copy_u_max's cross-rank
    maximum (value by a MAX all-reduce, gradient routed by a sum over
    the ranks that hold it): forward and gradients equal JAX's single
    device at rtol 1e-3 / atol 1e-5."""
    inputs, results = world
    inp = inputs["gin_max"]
    model = jax_model(GIN_MAX)
    g = jax_graph(batched_graph(seed=13), hetero=False)
    variables = jax.tree.map(jnp.asarray, inp["variables"])
    want = np.asarray(jax.jit(lambda v: model.apply(v, g, train=False))(
        variables))
    grads = jax.jit(jax.grad(lambda v: model.apply(v, g, train=False).sum()))(
        variables)
    want_g = port_worlds.flat(grads["params"])
    for rank in range(WORLD):
        logits, got_g = results[rank]["gin_max"]
        np.testing.assert_allclose(logits, want, rtol=1e-4, atol=1e-5)
        for k in want_g:
            np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_per_graph_occupancy_under_edge_sharding(world):
    """The heterogeneous models' per-graph occupancy (no JAX counterpart)
    all-reduces its relation counts over the group: the sharded forward
    of a per_graph_occupancy batch equals the unsharded one."""
    _, results = world
    for rank in range(WORLD):
        sharded, single = results[rank]["occupancy"]
        np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_all_reduce_sum_gradient_rule(world):
    """The differentiable all-reduce's backward sums over the group: four
    ranks, partial w * (rank + 1) summed, loss 5 * sum; the true gradient
    is 50, the ranks read 20, 40, 60 and 80, and their average is 50."""
    _, results = world
    assert [r["allreduce_rule"][0] for r in results] == [20.0, 40.0, 60.0,
                                                         80.0]
    assert [r["allreduce_rule"][1] for r in results] == [50.0] * WORLD
