"""Port parity of the TypedGraph model zoo (wsi_hgnn_tpu_torch/models/
{homogeneous,heterogeneous,layers}.py, config.py::parse_gnn_model,
convert.py) against the JAX package on the CPU: the same numpy batch of
two padded slides, the same weights carried across by `convert`, the
forward to 1e-4 and every parameter's gradient to 1e-4 relative."""
import functools
import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu import graph as jgraph
from wsi_hgnn_tpu.config import load_config as jax_load_config
from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import load_config, parse_gnn_model
from wsi_hgnn_tpu_torch.config import parse_lattice_twin
from wsi_hgnn_tpu_torch.graph import (batch_graphs, build_batch_device,
                                      from_arrays, sort_graph_edges,
                                      to_homogeneous)
import port_threads  # noqa: F401  (torch threads per test worker)

ROOT = Path(__file__).resolve().parent.parent
D, T, CPU = 8, 3, torch.device("cpu")

# small GNN sections, one per case; widths 16, 2 layers, 2 heads
_BASE = {"in_dim": D, "hidden_dim": 16, "out_dim": 3, "num_layers": 2,
         "n_node_types": T, "feat_drop": 0.0}
ZOO = {
    "gcn_att": dict(_BASE, name="GCN", graph_pooling_type="att"),
    "gcn_mean": dict(_BASE, name="GCN", graph_pooling_type="mean"),
    "gat": dict(_BASE, name="GAT", num_heads=2, num_out_heads=1,
                attn_drop=0.0, negative_slope=0.2, graph_pooling_type="mean",
                residual=True),
    "gin_att_mean": dict(_BASE, name="GIN", num_layers=3, num_mlp_layers=2,
                         graph_pooling_type="att",
                         neighbor_pooling_type="mean"),
    "gin_att_sum": dict(_BASE, name="GIN", num_layers=3, num_mlp_layers=2,
                        graph_pooling_type="att", neighbor_pooling_type="sum"),
    "gin_sum_sum": dict(_BASE, name="GIN", num_layers=3, num_mlp_layers=2,
                        graph_pooling_type="sum", neighbor_pooling_type="sum"),
    "ntpool": dict(_BASE, name="GCN_NTPool", graph_pooling_type="mean"),
    "hetrgcn": dict(_BASE, name="HetRGCN", graph_pooling_type="mean",
                    edge_types=["pos", "neg"]),
    "hgt": dict(_BASE, name="HGT", num_heads=2, graph_pooling_type="mean"),
    "heat2": dict(_BASE, name="HEAT2", n_heads=2, graph_pooling_type="mean"),
    "heat4": dict(_BASE, name="HEAT4", n_heads=2, graph_pooling_type="mean"),
}


def host_batch(seed=0, self_loops=False, n_types=T, sizes=(10, 14),
               edges=(30, 44), node_capacity=32, edge_capacity=112):
    """Two random slides batched and edge-sorted by the port's host code,
    with padding; slide 0 uses node types 0..1 only."""
    rng = np.random.RandomState(seed)
    graphs = []
    for i, (n, e) in enumerate(zip(sizes, edges)):
        nt = rng.randint(0, n_types if i else min(2, n_types), n)
        graphs.append(from_arrays(
            rng.randn(n, D).astype(np.float32), rng.randint(0, n, e),
            rng.randint(0, n, e), node_type=nt,
            esign=rng.randint(0, 2, e), sim=rng.uniform(-1, 1, e),
            n_node_types=n_types, add_self_loops=self_loops))
    return sort_graph_edges(batch_graphs(graphs, node_capacity=node_capacity,
                                         edge_capacity=edge_capacity))


def jax_graph(g):
    """The port's host graph as the JAX package's TypedGraph."""
    arr = {k: jnp.asarray(np.asarray(getattr(g, k))) for k in (
        "feat", "node_type", "node_graph", "node_mask", "src", "dst",
        "esign", "sim", "edge_mask")}
    ew = None if g.edge_weight is None else jnp.asarray(g.edge_weight)
    return jgraph.TypedGraph(**arr, edge_weight=ew, n_graphs=g.n_graphs,
                             n_node_types=g.n_node_types,
                             n_edge_types=g.n_edge_types,
                             edges_sorted=g.edges_sorted)


def graph_pair(is_hetero, seed=0):
    g = host_batch(seed, self_loops=not is_hetero)
    if not is_hetero:
        g = to_homogeneous(g)
    return jax_graph(g), g.to_torch(CPU)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def model_pair(case, seed=0):
    """(jax model, port model, flax variables, jax graph, port graph): the
    port's seeded flax-like weights as the flax tree both packages run
    (the tree's structure is held against JAX's init in
    test_parse_gnn_model_builds_every_shipped_config)."""
    jm, hetero = jax_parse_gnn_model(ZOO[case])
    tm, hetero_t = parse_gnn_model(ZOO[case])
    assert hetero_t == hetero
    g_j, g_t = graph_pair(hetero, seed)
    variables = convert.to_flax_variables(convert.init_flax_like_(tm, seed))
    variables = jax.tree.map(np.copy, variables)
    return jm, tm, variables, g_j, g_t


def grads_to_flax(tm):
    return flat(convert.params_to_flax(tm, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in tm.named_parameters()}))


def assert_tree_close(got, want, rtol):
    """Each leaf to `rtol` of its own largest entry, plus f32 rounding of
    the tree's largest (a gradient that is 0 in exact arithmetic, such as
    a bias ahead of a BatchNorm, is rounding noise in both packages)."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(v).max()) for v in want.values() if v.size)
    for k in want:
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * scale + 1e-6 * top, err_msg=k)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_forward_and_gradients_match_jax(case):
    """Eval-mode logits to 1e-4; the gradient of a fixed linear function
    of the logits (train mode: GIN's batch statistics, dropout 0) for
    every parameter to 1e-4 relative, the dead last layers' zeros
    included."""
    jm, tm, variables, g_j, g_t = model_pair(case)
    coef = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3)
    # HGT's layers drop out at their fixed 0.2: its gradient is eval-mode
    train = case != "hgt"
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    def loss(params):
        out = jm.apply(dict(variables, params=params), g_j, train=train,
                       mutable=mutable)
        logits = out[0] if mutable else out
        return (logits * coef).sum()

    @jax.jit
    def logits_and_grads(params):
        return (jm.apply(dict(variables, params=params), g_j, train=False),
                jax.grad(loss)(params))
    want, want_g = jax.tree.map(np.asarray,
                                logits_and_grads(variables["params"]))
    want_g = flat(want_g)
    tm.eval()
    with torch.no_grad():
        got = tm(g_t).numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    tm.train(train)
    tm.zero_grad(set_to_none=True)
    (tm(g_t) * torch.from_numpy(coef)).sum().backward()
    assert_tree_close(grads_to_flax(tm), want_g, rtol=1e-4)
    assert any(np.abs(v).max() > 0 for v in want_g.values())


@pytest.mark.parametrize("case", ["gin_att_mean", "gin_att_sum",
                                  "gin_sum_sum"])
def test_gin_running_statistics_match_jax(case):
    """One training forward folds the masked batch statistics into the
    running ones as flax does (momentum 0.9, unbiased variance)."""
    jm, _, variables, g_j, g_t = model_pair(case)
    tm, _ = parse_gnn_model(ZOO[case])
    convert.load_flax_variables(tm, variables)
    _, new = jax.jit(lambda v, g: jm.apply(v, g, train=True,
                                            mutable=["batch_stats"]))(
        variables, g_j)
    tm.train()
    with torch.no_grad():
        tm(g_t)
    got = flat(convert.to_flax_variables(tm)["batch_stats"])
    want = flat(jax.tree.map(np.asarray, new["batch_stats"]))
    assert sorted(got) == sorted(want) and len(want) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert not np.allclose(want["gin_0/bn/var"], 1.0)


@pytest.mark.parametrize("case", ["hgt", "gat"])
def test_flax_like_init_draws_flax_distributions(case):
    """init_flax_like_ draws every leaf as flax's init does: the same
    constant leaves (ones, zeros), and the random ones (lecun-normal
    kernels, HGT's xavier-uniform relation tensors, GAT's xavier-normal
    attention vectors, flax's fans) with JAX's spread (std within 10%,
    range within 10%) on leaves of at least 1024 entries."""
    section = dict(ZOO[case], in_dim=64, hidden_dim=256, num_heads=4)
    jm, hetero = jax_parse_gnn_model(section)
    tm, _ = parse_gnn_model(section)
    g_j, _ = graph_pair(hetero)
    g_j = g_j.replace(feat=jnp.zeros((g_j.num_nodes, 64)))
    want = flat(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), g_j)))
    got = flat(convert.to_flax_variables(convert.init_flax_like_(tm, 0)))
    assert sorted(got) == sorted(want)
    checked = []
    for k, w in want.items():
        if np.ptp(w) == 0:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        elif w.size >= 1024:
            np.testing.assert_allclose(got[k].std(), w.std(), rtol=0.1,
                                       err_msg=k)
            np.testing.assert_allclose(np.abs(got[k]).max(),
                                       np.abs(w).max(), rtol=0.1, err_msg=k)
            checked.append(k.rsplit("/", 1)[1])
    assert {"kernel", "relation_att", "relation_msg"} <= set(checked) or \
        {"kernel", "attn_l", "attn_r"} <= set(checked)


def test_typed_heat4_equals_the_lattice_twin():
    """On a KNN graph (lattice-packable) the TypedGraph HEATNet4 and its
    lattice twin with the same parameters give the same logits, batch
    presence on both; the parameter trees are the same."""
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(2, 40, D).astype(np.float32))
    types = torch.from_numpy(rng.randint(0, T, (2, 40)))
    types[0] %= 2
    mask = torch.arange(40)[None, :] < torch.tensor([[40], [31]])
    cfg = ZOO["heat4"]
    typed, _ = parse_gnn_model(cfg)
    twin = parse_lattice_twin(cfg)
    convert.init_flax_like_(typed, seed=3)
    variables = convert.to_flax_variables(typed)
    convert.load_flax_variables(twin, variables)
    assert sorted(flat(variables)) == sorted(flat(
        convert.to_flax_variables(twin)))
    from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device

    typed.eval()
    twin.eval()
    with torch.no_grad():
        got = typed(build_batch_device(feats, types, mask, 5, T))
        want = twin(build_lattice_device(feats, types, mask, 5, T))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _gnn_configs():
    return [Path(p) for p in sorted(glob.glob(str(ROOT / "configs/*/*.yml")))
            if "GNN" in load_config(p)]


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(section_key):
    section = dict(section_key)
    jm, hetero = jax_parse_gnn_model(section)
    g = host_batch(0, self_loops=not hetero,
                   n_types=int(section.get("n_node_types", 1)) if hetero else 1)
    g = jax_graph(g)
    g = g.replace(feat=jnp.zeros((g.num_nodes, int(section["in_dim"]))))
    shapes = jax.eval_shape(lambda k: jm.init(k, g), jax.random.PRNGKey(0))
    views = jax.tree.map(lambda s: np.broadcast_to(np.uint8(0), s.shape),
                         shapes)
    return hetero, {k: v.shape for k, v in flat(views).items()}


def _freeze(section):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in section.items()))


def test_parse_gnn_model_builds_every_shipped_config():
    """All 89 shipped model configs build in the port, ASAPGCN included,
    with the JAX model's heterogeneity and its variable tree leaf for leaf
    (shapes included)."""
    built = 0
    for path in _gnn_configs():
        section = load_config(path)["GNN"]
        assert jax_load_config(path)["GNN"] == section
        model, hetero = parse_gnn_model(section)
        want_hetero, want = _jax_param_shapes(_freeze(section))
        assert hetero == want_hetero, path
        got = {k: v.shape for k, v in
               flat(convert.to_flax_variables(model)).items()}
        assert got == want, path
        built += 1
    assert built == 89


def test_no_port_file_imports_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax or the JAX package (a grep of every import statement)."""
    import re

    bad = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|wsi_hgnn_tpu)"
                     r"(\.|\s|$)")
    files = sorted((ROOT / "wsi_hgnn_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    pkg = ROOT / "wsi_hgnn_tpu_torch"
    assert {pkg / "collectives.py", pkg / "parallel" / "mesh.py",
            pkg / "parallel" / "dp.py", pkg / "parallel" / "big_graph.py",
            pkg / "parallel" / "dryrun.py",
            pkg / "tools" / "convert_reference_checkpoint.py",
            pkg / "tools" / "convert_reference_graphs.py"} <= set(files)
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if bad.match(line)]
    assert not hits, hits
