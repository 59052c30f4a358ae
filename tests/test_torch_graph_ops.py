"""Port parity of the graph layer (wsi_hgnn_tpu_torch/graph/{typed_graph,
ops,batch,transforms}.py) against the JAX package on the CPU: the same
numpy graphs from a seed through both packages' segment ops, readouts,
batching, edge sort and augmentation."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu import graph as jgraph
from wsi_hgnn_tpu.graph import ops as jops
from wsi_hgnn_tpu.graph import transforms as jtr
from wsi_hgnn_tpu.graph import typed_graph as jtg
from wsi_hgnn_tpu.graph.batch import sort_graph_edges as jax_sort
from wsi_hgnn_tpu_torch import graph as tgraph
from wsi_hgnn_tpu_torch.graph import ops as tops
from wsi_hgnn_tpu_torch.graph import transforms as ttr
import port_threads  # noqa: F401  (torch threads per test worker)

T, D, CPU = 3, 5, torch.device("cpu")
FIELDS = ("feat", "node_type", "node_graph", "node_mask", "src", "dst",
          "esign", "sim", "edge_mask")


def _slides(seed, self_loops=False, n_types=T):
    """Three slides of (numpy) arrays: one with no edges into its last
    nodes (empty segments), one with a node type missing."""
    rng = np.random.RandomState(seed)
    out = []
    for n, e in ((6, 9), (9, 20), (4, 0)):
        src = rng.randint(0, n - 2, e)   # the last two nodes send nothing
        dst = rng.randint(0, n - 1, e)   # and the last receives nothing
        out.append(dict(
            feat=rng.randn(n, D).astype(np.float32), src=src, dst=dst,
            node_type=rng.randint(0, n_types - 1, n), esign=rng.randint(0, 2, e),
            sim=rng.uniform(-1, 1, e).astype(np.float32),
            n_node_types=n_types, add_self_loops=self_loops))
    return out


def _both(seed, self_loops=False, edge_weight=False, sort=True,
          node_capacity=32, edge_capacity=64):
    """(jax graph, port host graph): each package batches the same slides
    itself; the port's batch must be array-equal to JAX's."""
    slides = _slides(seed, self_loops)
    jb = jgraph.batch_graphs(
        [jgraph.from_arrays(s.pop("feat"), s.pop("src"), s.pop("dst"), **s)
         for s in _slides(seed, self_loops)],
        node_capacity=node_capacity, edge_capacity=edge_capacity)
    tb = tgraph.batch_graphs(
        [tgraph.from_arrays(s.pop("feat"), s.pop("src"), s.pop("dst"), **s)
         for s in slides],
        node_capacity=node_capacity, edge_capacity=edge_capacity)
    if edge_weight:
        w = np.random.RandomState(seed + 7).uniform(0, 2, edge_capacity
                                                    ).astype(np.float32)
        jb = jb.replace(edge_weight=w)
        tb = tb.replace(edge_weight=w)
    if sort:
        jb, tb = jax_sort(jb), tgraph.sort_graph_edges(tb)
    _assert_equal(tb, jb)
    jb = jax.tree.map(jnp.asarray, jb)
    return jb, tb


def _assert_equal(tb, jb):
    for f in FIELDS + ("edge_weight",):
        a, b = getattr(tb, f), getattr(jb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
    for f in ("n_graphs", "n_node_types", "n_edge_types", "edges_sorted"):
        assert getattr(tb, f) == getattr(jb, f), f


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("edge_weight", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_segment_ops_and_readouts_match_jax(edge_weight, sort):
    """Every aggregation and readout on a padded batch with empty
    segments and masked edges (a third of the real edges cleared), with
    and without the per-edge weight, sorted or not."""
    jb, tb = _both(1, edge_weight=edge_weight, sort=sort)
    rng = np.random.RandomState(2)
    keep = rng.rand(jb.num_edges) > 0.33
    jb = jb.replace(edge_mask=jb.edge_mask & keep)
    g = tb.replace(edge_mask=tb.edge_mask & keep).to_torch(CPU)
    node = rng.randn(jb.num_nodes, 2, 4).astype(np.float32)
    edge = rng.randn(jb.num_edges, 2, 4).astype(np.float32)
    flat = node.reshape(jb.num_nodes, -1)
    gate = rng.randn(jb.num_nodes, 1).astype(np.float32)
    tn, te, tf, tg = map(torch.from_numpy, (node, edge, flat, gate))
    pairs = [
        (jops.copy_e_sum(jb, edge), tops.copy_e_sum(g, te)),
        (jops.u_mul_e_sum(jb, node, edge), tops.u_mul_e_sum(g, tn, te)),
        (jops.copy_u_sum(jb, node), tops.copy_u_sum(g, tn)),
        (jops.copy_u_mean(jb, node), tops.copy_u_mean(g, tn)),
        (jops.copy_u_max(jb, node), tops.copy_u_max(g, tn)),
        (jops.v_dot_u(jb, node, node), tops.v_dot_u(g, tn, tn)),
        (jops.edge_softmax_by_dst_rel(jb, edge[:, :, 0]),
         tops.edge_softmax_by_dst_rel(g, te[:, :, 0])),
        (jops.readout_attention(jb, flat, gate),
         tops.readout_attention(g, tf, tg)),
        (jops.readout_mean_all_types(jb, flat),
         tops.readout_mean_all_types(g, tf)),
        (jops.readout_sum_all_types(jb, flat),
         tops.readout_sum_all_types(g, tf)),
        (jops.readout_max_all_types(jb, flat),
         tops.readout_max_all_types(g, tf)),
    ]
    for kind in ("sum", "mean", "max"):
        for ntype in (None, 0, T - 1):
            pairs.append((getattr(jops, f"readout_{kind}")(jb, flat, ntype),
                          getattr(tops, f"readout_{kind}")(g, tf, ntype)))
    pairs.append((jops.readout_attention(jb, flat, gate, 1),
                  tops.readout_attention(g, tf, tg, 1)))
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6,
                                   err_msg=f"pair {i}")
    # the empty segments read 0 in both
    assert not _np(pairs[2][1])[tb.num_nodes - 1].any()
    assert (_np(pairs[-3][1])[2 * T:] == 0).all()   # slide 2: no type T-1


@pytest.mark.parametrize("mask", [False, True])
def test_segment_softmax_gradient_matches_jax(mask):
    """The gradient through segment_softmax (the max detached, as JAX's
    stop_gradient) against jax.grad, with an empty segment and masked
    entries."""
    rng = np.random.RandomState(3)
    scores = (rng.randn(40, 3) * 4).astype(np.float32)
    seg = rng.randint(0, 6, 40)
    seg[seg == 4] = 5   # segment 4 is empty
    m = rng.rand(40) > 0.3 if mask else None
    up = rng.randn(40, 3).astype(np.float32)

    def jloss(s):
        p = jops.segment_softmax(s, jnp.asarray(seg), 7,
                                 None if m is None else jnp.asarray(m))
        return (p * up).sum()
    want_p = jops.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 7,
                                  None if m is None else jnp.asarray(m))
    want = jax.grad(jloss)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    p = tops.segment_softmax(s, torch.from_numpy(seg), 7,
                             None if m is None else torch.from_numpy(m))
    (p * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(_np(p), np.asarray(want_p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if mask:
        assert not s.grad.numpy()[~m].any()


@pytest.mark.parametrize("self_loops", [False, True])
def test_batch_sort_and_views_match_jax(self_loops):
    """batch_graphs, sort_graph_edges (padding edges last, dst pinned to
    the last slot, edge weights carried), repad_graph, to_homogeneous,
    degrees with and without implicit self-loops, relation and type
    counts: array-equal to JAX."""
    for ew in (False, True):
        jb, tb = _both(4, self_loops=self_loops, edge_weight=ew)
    emask = np.asarray(tb.edge_mask)
    assert emask[: emask.sum()].all()
    assert (np.asarray(tb.dst)[~emask] == tb.num_nodes - 1).all()

    g = tb.to_torch(CPU)
    assert g.src.dtype == torch.int64 and g.feat.dtype == torch.float32
    for flag in (False, True):
        for got, want in zip(g.degrees(implicit_self_loops=flag),
                             jb.degrees(implicit_self_loops=flag)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(g.edge_rel()), np.asarray(jb.edge_rel()))
    np.testing.assert_array_equal(_np(g.rel_edge_counts()),
                                  np.asarray(jb.rel_edge_counts()))
    np.testing.assert_array_equal(_np(g.node_type_counts()),
                                  np.asarray(jb.node_type_counts()))

    homo_t, homo_j = tgraph.to_homogeneous(g), jgraph.to_homogeneous(jb)
    assert homo_t.n_node_types == 1 and not homo_t.node_type.any()
    np.testing.assert_array_equal(_np(homo_t.edge_rel()),
                                  np.asarray(homo_j.edge_rel()))
    assert tgraph.to_homogeneous(tb).n_node_types == 1

    slide = _slides(5, self_loops)[1]
    tg = tgraph.from_arrays(slide.pop("feat"), slide.pop("src"),
                            slide.pop("dst"), **slide)
    slide = _slides(5, self_loops)[1]
    jg = jgraph.from_arrays(slide.pop("feat"), slide.pop("src"),
                            slide.pop("dst"), **slide)
    _assert_equal(tgraph.repad_graph(tg, 48, 96),
                  jtg.repad_graph(jg, 48, 96))
    with pytest.raises(ValueError, match="capacity"):
        tgraph.batch_graphs([tg, tg], node_capacity=8)


def _jax_aug_masks(key, g):
    """The masks jax train_transform draws from `key` (p = 0.5)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.bernoulli(k1, 0.5, (g.num_nodes,)),
            jax.random.bernoulli(k2, 0.5, (g.num_edges,)),
            jax.random.bernoulli(k3, 0.5, (g.feat_dim,)))


@pytest.mark.parametrize("self_loops", [False, True])
def test_transforms_match_jax_with_its_masks(self_loops):
    """Fed the masks JAX drew, DropNode -> DropEdge -> FeatMask equals
    jax train_transform exactly (self-loops survive DropEdge); drawing
    from a generator leaves torch's global RNG alone."""
    jb, tb = _both(6, self_loops=self_loops)
    g = tb.to_torch(CPU)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jtr.train_transform(jb, key)
        masks = ttr.TrainMasks(*(torch.from_numpy(np.array(m))
                                 for m in _jax_aug_masks(key, jb)))
        got = ttr.apply_train_masks(g, masks)
        for f in FIELDS:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        if self_loops:
            loops = _np(g.src == g.dst) & _np(got.node_mask)[_np(g.src)]
            assert _np(got.edge_mask)[loops & _np(g.edge_mask)].all()
    state = torch.random.get_rng_state()
    drawn = ttr.draw_train_masks(g, torch.Generator().manual_seed(0))
    assert [m.shape for m in drawn] == [(g.num_nodes,), (g.num_edges,), (D,)]
    assert torch.equal(torch.random.get_rng_state(), state)
    torch.testing.assert_close(
        ttr.train_transform(g, torch.Generator().manual_seed(0)).feat,
        ttr.apply_train_masks(g, drawn).feat)


@pytest.mark.parametrize("self_loops", [False, True])
def test_build_batch_device_matches_jax(self_loops):
    """Per-slide KNN (k = 4) + Pearson construction of a padded [2, 40]
    cohort (slide 1 with 9 padding rows and a tie) into one batched
    TypedGraph: every index and mask leaf equal to JAX's, sim to 1e-6."""
    from wsi_hgnn_tpu.graph.build import build_batch_device as jax_build

    rng = np.random.RandomState(8)
    feats = rng.randn(2, 40, D).astype(np.float32)
    feats[1, 5] = feats[1, 6]
    types = rng.randint(0, T, (2, 40)).astype(np.int32)
    mask = np.arange(40)[None, :] < np.array([[40], [31]])
    want = jax_build(jnp.asarray(feats), jnp.asarray(types),
                     jnp.asarray(mask), 5, T, add_self_loops=self_loops)
    got = tgraph.build_batch_device(
        torch.from_numpy(feats), torch.from_numpy(types),
        torch.from_numpy(mask), 5, T, add_self_loops=self_loops)
    for f in FIELDS:
        if f == "sim":
            np.testing.assert_allclose(_np(got.sim), np.asarray(want.sim),
                                       rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    assert (got.n_graphs, got.n_node_types) == (2, T)
