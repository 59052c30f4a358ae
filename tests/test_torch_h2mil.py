"""Port parity of H2MIL (wsi_hgnn_tpu_torch/models/mil/h2mil.py) against
the JAX package on the CPU, the same numpy inputs on both sides and the
weights carried across by `convert`.

Tolerances: the tree builders and `scan_nested_bag` give equal arrays;
IHPool's cluster assignments (the relabelled edges, the pooled masks,
types and parents) are exactly equal, its pooled features within 1e-6;
RAConv and the H2MIL forward within 1e-5 relative, their gradients within
1e-4 relative L2. The training lockstep is in test_torch_h2mil_lockstep.py
(its eager JAX side takes most of a minute alone)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.models.mil import h2mil as jh2
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.models.mil import h2mil as th2
import port_threads  # noqa: F401  (torch threads per test worker)

D, H, C = 12, 8, 2


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def single_level(n=60, seed=0, scale=1.0, cap_n=None, cap_e=None):
    """A single-magnification bag on a ragged tile grid, as a numpy tree."""
    rng = np.random.RandomState(seed)
    cells = rng.permutation(14 * 9)[:n]
    xy = np.stack([cells % 14, cells // 14], 1)
    feats = (rng.randn(n, D) * scale).astype(np.float32)
    return th2.build_tree_graph(feats, xy, cell=3, node_capacity=cap_n,
                                edge_capacity=cap_e, bucket_base=64)


def two_level(seed=1, thumb=True):
    rng = np.random.RandomState(seed)
    cells = rng.permutation(6 * 5)[:17]
    xy1 = np.stack([cells % 6, cells // 6], 1)
    xy2, parent = [], []
    for i, (x, y) in enumerate(xy1):
        for dx in range(2):
            for dy in range(2):
                if rng.rand() < 0.7:
                    xy2.append((2 * x + dx, 2 * y + dy))
                    parent.append(i)
    f1 = rng.randn(len(xy1), D).astype(np.float32)
    f2 = rng.randn(len(xy2), D).astype(np.float32)
    tf = rng.randn(D).astype(np.float32) if thumb else None
    return (f1, xy1, f2, np.asarray(xy2), np.asarray(parent), tf)


def to_jax(t):
    return jh2.TreeGraph(*(jnp.asarray(a) for a in t))


def to_port(t, dtype=torch.float32):
    return th2.tree_to_torch(t, "cpu", dtype)


@pytest.mark.parametrize("case", ["single", "single_capacity", "levels",
                                  "levels_no_thumb"])
def test_tree_builders_equal_jax(case):
    if case.startswith("single"):
        rng = np.random.RandomState(3)
        cells = rng.permutation(200)[:70]
        xy = np.stack([cells % 20, cells // 20], 1)
        f = rng.randn(70, D).astype(np.float32)
        kw = dict(node_capacity=128, edge_capacity=1024) \
            if case == "single_capacity" else {}
        got = th2.build_tree_graph(f, xy, cell=4, **kw)
        want = jh2.build_tree_graph(f, xy, cell=4, **kw)
    else:
        args = two_level(thumb=case == "levels")
        got = th2.build_tree_graph_levels(*args, bucket_base=64)
        want = jh2.build_tree_graph_levels(*args, bucket_base=64)
    for name, g, w in zip(th2.TreeGraph._fields, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    with pytest.raises(ValueError, match="capacity"):
        th2.build_tree_graph(np.zeros((5, D), np.float32),
                             np.stack([np.arange(5), np.zeros(5)], 1),
                             node_capacity=4)


def test_scan_nested_bag_equals_jax(tmp_path):
    """The nested layout with a thumbnail, a childless low tile and a
    child directory of several tiles."""
    bag = tmp_path / "slide"
    bag.mkdir()
    for name in ("0_0", "0_1", "1_0", "3_2", "-1"):
        (bag / f"{name}.jpeg").write_bytes(b"x")
    for low, kids in (("0_0", ("0_0", "1_0", "1_1")), ("1_0", ("2_1",)),
                      ("3_2", ("6_4", "7_5"))):
        (bag / low).mkdir()
        for k in kids:
            (bag / low / f"{k}.jpeg").write_bytes(b"x")
    got = th2.scan_nested_bag(bag)
    want = jh2.scan_nested_bag(bag)
    assert got[0] == want[0] and got[2] == want[2] and got[5] == want[5]
    for i in (1, 3, 4):
        assert got[i].dtype == want[i].dtype
        np.testing.assert_array_equal(got[i], want[i])
    (bag / "-1.jpeg").unlink()
    assert th2.scan_nested_bag(bag)[5] is None
    with pytest.raises(FileNotFoundError):
        th2.scan_nested_bag(tmp_path)


def _grads_close(got, want, rtol=1e-4):
    """Relative L2 per leaf, floored by 1e-6 of the largest gradient."""
    top = max(np.linalg.norm(v) for v in want.values())
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= rtol * np.linalg.norm(want[k]) + 1e-6 * top, \
            (k, err, np.linalg.norm(want[k]))


def _port_grads(tm):
    return flat(convert.params_to_flax(tm, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in tm.named_parameters()}))


def test_port_tree_equals_jax_init_tree():
    """Same leaves and shapes as flax's init (fold pickles cross), the
    attention vectors xavier-uniform with flax's fans and the pool
    weights U[0, 1)."""
    t = single_level()
    tm = convert.init_flax_like_(th2.H2MIL(D, 16, C, k1=4, k2=8), 0)
    got = flat(convert.to_flax_variables(tm))
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        jh2.H2MIL(hidden_dim=16, n_classes=C, k1=4, k2=8).init,
        jax.random.PRNGKey(0), to_jax(t)))[0]
    assert {k: v.shape for k, v in got.items()} == {
        "/".join(p.key for p in path): tuple(v.shape) for path, v in want}
    w = got["params/pool_1/weight_1"]
    assert w.min() >= 0.0 and w.max() < 1.0
    att = got["params/conv1/att_l"]
    limit = np.sqrt(6.0 / (1 + 16))
    assert np.abs(att).max() <= limit and att.std() > 0.3 * limit


def test_raconv_forward_and_gradients_match_jax():
    t = single_level(cap_n=128, cap_e=768)
    tm = convert.init_flax_like_(th2.RAConvLayer(D, H, heads=2), 4)
    variables = convert.to_flax_variables(tm)
    jm = jh2.RAConvLayer(features=H, heads=2)
    jt = to_jax(t)
    coef = np.random.RandomState(0).randn(t.feats.shape[0], 2 * H
                                          ).astype(np.float32)

    def loss(p, x):
        return (jm.apply({"params": p}, jt, x) * coef).sum()

    x = t.feats
    want = np.asarray(jm.apply(variables, jt, jnp.asarray(x)))
    want_g, want_gx = jax.grad(loss, argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(to_port(t), xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    (out * torch.from_numpy(coef)).sum().backward()
    _grads_close(_port_grads(tm), flat(want_g))
    _grads_close({"x": xt.grad.numpy()}, {"x": np.asarray(want_gx)})


@pytest.mark.parametrize("case", ["plain", "saturated", "few_valid",
                                  "levels"])
def test_ihpool_assignments_equal_jax(case):
    """Cluster assignments exactly equal: a plain tree; fitness saturated
    to exactly +-1 in f32 (ties in both sorts); fewer valid level-2 nodes
    than the budget; a real two-level tree."""
    k1, k2 = 4, 12
    if case == "levels":
        t = th2.build_tree_graph_levels(*two_level(), bucket_base=64)
    else:
        t = single_level(n=10 if case == "few_valid" else 60,
                         scale=1e4 if case == "saturated" else 1.0)
    tm = convert.init_flax_like_(th2.IHPool(D, k1, k2), 7)
    variables = convert.to_flax_variables(tm)
    if case == "saturated":
        f = np.tanh(t.feats @ variables["params"]["weight_2"][0]
                    / np.linalg.norm(variables["params"]["weight_2"]))
        assert (np.abs(f[t.node_mask]) == 1.0).sum() > 10
    g_want, x_want = jh2.IHPool(k1, k2).apply(variables, to_jax(t),
                                              jnp.asarray(t.feats))
    with torch.no_grad():
        g_got, x_got = tm(to_port(t), torch.from_numpy(t.feats))
    for name in ("src", "dst", "node_type", "tree", "node_mask",
                 "edge_mask"):
        np.testing.assert_array_equal(getattr(g_got, name).numpy(),
                                      np.asarray(getattr(g_want, name)),
                                      err_msg=name)
    for got, want in ((x_got, x_want), (g_got.xy, g_want.xy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("which", ["single", "levels"])
def test_h2mil_forward_and_gradients_match_jax(which):
    if which == "single":
        t = single_level(n=80, seed=2)
    else:
        t = th2.build_tree_graph_levels(*two_level(seed=4), bucket_base=64)
    tm = convert.init_flax_like_(th2.H2MIL(D, 16, C, k1=4, k2=8), 5).eval()
    variables = convert.to_flax_variables(tm)
    jm = jh2.H2MIL(hidden_dim=16, n_classes=C, k1=4, k2=8)
    jt = to_jax(t)

    def loss(p):
        lg = jm.apply({"params": p}, jt)
        return lg[0, 0] - 2.0 * lg[0, 1]

    want = np.asarray(jax.jit(jm.apply)(variables, jt))
    want_g = flat(jax.jit(jax.grad(loss))(variables["params"]))
    out = tm(to_port(t))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    (out[0, 0] - 2.0 * out[0, 1]).backward()
    got_g = _port_grads(tm)
    assert not got_g["pool_1/weight_1"].any()
    _grads_close(got_g, want_g)
