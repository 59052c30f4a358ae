"""Heterogeneous GNN zoo: HetRGCN, HGT, HEATNet2, HEATNet4 on the
TypedGraph (counterparts of wsi_hgnn_tpu/models/heterogeneous.py).

DGL semantics kept exactly:
  * edge_softmax runs per (dst node, canonical relation) group;
  * multi_update_all(..., cross_reducer='mean') divides a node's summed
    messages by the number of canonical relations with >= 1 edge in the
    (batched) graph that target the node's type;
  * node types with no incoming relation pass their features through;
  * node types with no node in the batch add nothing to the pooled sum.
Occupancy is over the graph the model is given: the whole batch in
training, one slide at a time in evaluation and serving. A graph with
`per_graph_occupancy` set has each graph of its flat batch count its own,
so the batch computes what one forward per graph computes. On an edge
shard (`edge_group`) the relation counts of either kind are summed over
the group.

`forward(g, drops=None)` returns logits [n_graphs, out_dim]; training-mode
dropout takes its masks from `drops` (layers.DropSource). The HEAT models
have the lattice twins' parameter tree (models/lattice.py), so a
checkpoint of either path loads into the other.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import ops
from ..graph.typed_graph import TypedGraph
from .layers import (DropSource, LinearAttentionBlock, TypedDense, TypedHeads,
                     TypedLayerNorm, dropout, pool_all_types)


class Presence(NamedTuple):
    """Relation and node-type occupancy of a graph, over the whole batch
    (G = 1 row) or per graph (G = n_graphs rows)."""

    present: torch.Tensor       # [G, R] bool: the relation has an edge
    dst_denom: torch.Tensor     # [G, T] present relations into each type
    src_denom: torch.Tensor     # [G, T] present relations out of each type
    type_present: torch.Tensor  # [G, T] bool: the type has a node
    row: torch.Tensor           # [N] each node's row of the [G * T] tables


def _presence(g: TypedGraph) -> Presence:
    """Occupancy of g in the features' float type: over the whole
    (batched) graph, or per graph where g.per_graph_occupancy is set."""
    t, r = g.n_node_types, g.n_relations
    if g.per_graph_occupancy:
        seg = ops.gather(g.node_graph, g.src) * r + g.edge_rel()
        counts = g.reduce_edges(torch.zeros(
            g.n_graphs * r, dtype=torch.long, device=seg.device).index_add_(
            0, seg, g.edge_mask.long()))
        present = counts.reshape(g.n_graphs, r) > 0
        types = g.node_type_counts().reshape(g.n_graphs, t) > 0
        row = g.node_graph * t + g.node_type
    else:
        present = (g.rel_edge_counts() > 0)[None]
        types = (g.node_type_counts().reshape(g.n_graphs, t).sum(0) > 0)[None]
        row = g.node_type
    rel_ids = torch.arange(r, device=present.device)
    pf = present.to(g.feat.dtype)
    dst_denom = pf @ F.one_hot(rel_ids % t, t).to(pf.dtype)
    src_denom = pf @ F.one_hot((rel_ids // t) % t, t).to(pf.dtype)
    return Presence(present, dst_denom, src_denom, types, row)


def _per_node(table: torch.Tensor, p: Presence) -> torch.Tensor:
    """A [G, T] occupancy table read at each node's row."""
    return ops.gather(table.reshape(-1), p.row)


def _skip_mix(h_new, h_old, alpha, node_type, has_update, node_mask):
    """trans*a + h*(1-a), h where the node's type got no update."""
    a = ops.gather(torch.sigmoid(alpha), node_type)[:, None]
    mixed = h_new * a + h_old * (1.0 - a)
    return torch.where((has_update & node_mask)[:, None], mixed, h_old)


# --------------------------------------------------------------------- #
# HetRGCN
# --------------------------------------------------------------------- #
class HetRGCNLayer(nn.Module):
    """Reference HeteroRGCNLayer. It passes NO messages: for each canonical
    relation present it computes W_r(h[src type]) and averages the results
    per SOURCE type. By linearity that is h @ mean(W_r) + mean(b_r) over
    the present relations of each source type: one typed GEMM."""

    def __init__(self, n_types: int, n_edge_types: int, in_features: int,
                 features: int):
        super().__init__()
        self.n_types = n_types
        r = n_edge_types * n_types * n_types
        self.kernel = nn.Parameter(torch.empty(r, in_features, features))
        self.bias = nn.Parameter(torch.zeros(r, features))

    def forward(self, g: TypedGraph, h: torch.Tensor) -> torch.Tensor:
        t = self.n_types
        if g.n_relations != self.kernel.shape[0]:
            raise ValueError(f"graph has {g.n_relations} relations, the "
                             f"layer {self.kernel.shape[0]}")
        p = _presence(g)
        rel_ids = torch.arange(g.n_relations, device=h.device)
        onehot = F.one_hot((rel_ids // t) % t, t).to(h.dtype)[None] \
            * p.present.to(h.dtype)[:, :, None]                  # [G, R, T]
        denom = p.src_denom.clamp_min(1.0)
        w_eff = torch.einsum("grt,rdf->gtdf", onehot, self.kernel) \
            / denom[:, :, None, None]
        b_eff = torch.einsum("grt,rf->gtf", onehot, self.bias) \
            / denom[:, :, None]
        if w_eff.shape[0] == 1:
            out = ops.typed_linear(h, g.node_type, w_eff[0], b_eff[0])
        else:   # one (graph, type) row per node: one product per row
            out = ops.typed_linear_ragged(h, p.row, w_eff.flatten(0, 1),
                                          b_eff.flatten(0, 1))
        has_update = _per_node(p.src_denom > 0, p)
        return torch.where((has_update & g.node_mask)[:, None], out, h)


class HetRGCN(nn.Module):
    """Reference HeteroRGCN: a typed input projection with exact-erf GELU,
    then HetRGCN layers, per-type pooled heads summed over present types
    and layers. The last layer's output reaches no head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, n_node_types: int, n_edge_types: int = 2,
                 graph_pooling_type: str = "sum"):
        super().__init__()
        t = n_node_types
        self.n_types, self.n_layers, self.out_dim = t, n_layers, out_dim
        self.graph_pooling_type = graph_pooling_type
        self.adapt_ws = TypedDense(t, in_dim, hidden_dim)
        for i in range(n_layers):
            self.add_module(f"pred_{i}", TypedHeads(t, hidden_dim, out_dim))
            self.add_module(f"layer_{i}", HetRGCNLayer(
                t, n_edge_types, hidden_dim, hidden_dim))

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        pres = _presence(g).type_present.to(g.feat.dtype)
        h = F.gelu(self.adapt_ws(g.feat, g.node_type))
        hg = g.feat.new_zeros(g.n_graphs, self.out_dim)
        for i in range(self.n_layers):
            pooled = pool_all_types(g, h, self.graph_pooling_type)
            heads = getattr(self, f"pred_{i}")(pooled)
            hg = hg + (heads * pres[:, :, None]).sum(1)
            h = getattr(self, f"layer_{i}")(g, h)
        return hg


# --------------------------------------------------------------------- #
# HGT
# --------------------------------------------------------------------- #
class HGTLayer(nn.Module):
    """Reference HGTLayer. The per-relation K and V transforms
    (relation_att / relation_msg, [R, H, dk, dk]) are applied at the node
    level for every (edge sign, dst type) combo, 2*T versions per node
    instead of R per edge, then gathered per edge by its relation.
    Attention is the per-(dst, relation) softmax of
    q.k * relation_pri / sqrt(dk); the aggregation is one segment sum with
    the cross_reducer='mean' denominator per dst type."""

    def __init__(self, n_types: int, in_features: int, out_dim: int,
                 n_heads: int, n_edge_types: int = 2, dropout: float = 0.2,
                 use_norm: bool = True):
        super().__init__()
        t = n_types
        self.n_types, self.out_dim, self.n_heads = t, out_dim, n_heads
        self.n_edge_types = n_edge_types
        self.dropout = float(dropout)
        self.use_norm = use_norm
        d_k = out_dim // n_heads
        n_rel = n_edge_types * t * t
        for name in ("k_linears", "q_linears", "v_linears"):
            self.add_module(name, TypedDense(t, in_features, out_dim))
        self.relation_att = nn.Parameter(torch.empty(n_rel, n_heads, d_k, d_k))
        self.relation_msg = nn.Parameter(torch.empty(n_rel, n_heads, d_k, d_k))
        self.relation_pri = nn.Parameter(torch.ones(n_rel, n_heads))
        self.skip = nn.Parameter(torch.ones(t))
        self.a_linears = TypedDense(t, out_dim, out_dim)
        if use_norm:
            self.norms = TypedLayerNorm(t, out_dim)

    def forward(self, g: TypedGraph, h: torch.Tensor,
                drops: Optional[DropSource] = None) -> torch.Tensor:
        t, e_t = self.n_types, self.n_edge_types
        n_h, d_k = self.n_heads, self.out_dim // self.n_heads
        nt = g.node_type
        k = self.k_linears(h, nt).reshape(-1, n_h, d_k)
        q = self.q_linears(h, nt).reshape(-1, n_h, d_k)
        v = self.v_linears(h, nt).reshape(-1, n_h, d_k)

        # node-level per-(sign, dst-type) transforms, combo = sign*T + dst_t
        onehot_s = F.one_hot(nt, t).to(h.dtype)                  # [N, T]
        a_r = self.relation_att.reshape(e_t, t, t, n_h, d_k, d_k)
        m_r = self.relation_msg.reshape(e_t, t, t, n_h, d_k, d_k)
        ks = torch.einsum("ns,nhd->nshd", onehot_s, k)
        vs = torch.einsum("ns,nhd->nshd", onehot_s, v)
        k_c = torch.einsum("nshd,zsthde->nzthe", ks, a_r).reshape(-1, n_h, d_k)
        v_c = torch.einsum("nshd,zsthde->nzthe", vs, m_r).reshape(-1, n_h, d_k)

        combo = g.esign * t + ops.gather(nt, g.dst)
        row = g.src * (e_t * t) + combo                 # into [N * 2T] rows
        k_e = ops.gather(k_c, row)                                 # [E, H, dk]
        v_e = ops.gather(v_c, row)
        q_e = ops.gather(q, g.dst)
        pri = ops.gather(self.relation_pri, g.edge_rel())
        score = (q_e * k_e).sum(-1) * pri / math.sqrt(d_k)         # [E, H]
        attn = ops.edge_softmax_by_dst_rel(g, score)
        agg = ops.copy_e_sum(g, v_e * attn[:, :, None]).reshape(-1,
                                                               self.out_dim)

        p = _presence(g)
        t_agg = agg / _per_node(p.dst_denom.clamp_min(1.0), p)[:, None]
        trans = dropout(self, drops, self.a_linears(t_agg, nt), self.dropout)
        has_update = _per_node(p.dst_denom > 0, p)
        out = _skip_mix(trans, h, self.skip, nt, has_update, g.node_mask)
        if self.use_norm:
            keep = (has_update & g.node_mask)[:, None]
            out = torch.where(keep, self.norms(out, nt), out)
        return out


class HGT(nn.Module):
    """Reference HGT: typed input projection with exact-erf GELU, HGT
    layers (dropout 0.2, the layer's default), per-type pooled heads
    before each layer, summed over present types and layers. The last
    layer's output reaches no head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, n_heads: int, n_node_types: int,
                 use_norm: bool = True, graph_pooling_type: str = "mean"):
        super().__init__()
        t = n_node_types
        self.n_types, self.n_layers, self.out_dim = t, n_layers, out_dim
        self.graph_pooling_type = graph_pooling_type
        self.adapt_ws = TypedDense(t, in_dim, hidden_dim)
        for i in range(n_layers):
            self.add_module(f"pred_{i}", TypedHeads(t, hidden_dim, out_dim))
            self.add_module(f"gcs_{i}", HGTLayer(
                t, hidden_dim, hidden_dim, n_heads, use_norm=use_norm))

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        pres = _presence(g).type_present.to(g.feat.dtype)
        h = F.gelu(self.adapt_ws(g.feat, g.node_type))
        hg = g.feat.new_zeros(g.n_graphs, self.out_dim)
        for i in range(self.n_layers):
            pooled = pool_all_types(g, h, self.graph_pooling_type)
            heads = getattr(self, f"pred_{i}")(pooled)
            hg = hg + (heads * pres[:, :, None]).sum(1)
            h = getattr(self, f"gcs_{i}")(g, h, drops)
        return hg


# --------------------------------------------------------------------- #
# HEAT
# --------------------------------------------------------------------- #
class HEATLayer(nn.Module):
    """Reference HEATLayer: HGT-style per-type K/Q/V without per-relation
    tensors; the Pearson edge attribute `sim` through a 1 -> 1 Dense
    scales the attention logits before the per-(dst, relation) softmax."""

    def __init__(self, n_types: int, in_features: int, out_dim: int,
                 n_heads: int, dropout: float = 0.2,
                 typed_impl: str = "onehot"):
        super().__init__()
        self.n_types, self.out_dim, self.n_heads = n_types, out_dim, n_heads
        self.dropout = float(dropout)
        for name in ("k_linears", "q_linears", "v_linears"):
            self.add_module(name, TypedDense(n_types, in_features, out_dim,
                                             typed_impl))
        self.a_linears = TypedDense(n_types, out_dim, out_dim, typed_impl)
        self.skip = nn.Parameter(torch.ones(n_types))
        self.e_linear = nn.Linear(1, 1)

    def forward(self, g: TypedGraph, h: torch.Tensor, tsort=None,
                drops: Optional[DropSource] = None) -> torch.Tensor:
        n_h, d_k = self.n_heads, self.out_dim // self.n_heads
        nt = g.node_type
        k = self.k_linears(h, nt, tsort).reshape(-1, n_h, d_k)
        q = self.q_linears(h, nt, tsort).reshape(-1, n_h, d_k)
        v = self.v_linears(h, nt, tsort).reshape(-1, n_h, d_k)
        ea = self.e_linear(g.sim[:, None].to(h.dtype))              # [E, 1]
        score = ops.v_dot_u(g, q, k) * ea / math.sqrt(d_k)          # [E, H]
        attn = ops.edge_softmax_by_dst_rel(g, score)
        agg = ops.copy_e_sum(g, ops.gather(v, g.src) * attn[:, :, None]
                             ).reshape(-1, self.out_dim)
        p = _presence(g)
        t_agg = agg / _per_node(p.dst_denom.clamp_min(1.0), p)[:, None]
        trans = dropout(self, drops, self.a_linears(t_agg, nt, tsort),
                        self.dropout)
        return _skip_mix(trans, h, self.skip, nt,
                         _per_node(p.dst_denom > 0, p), g.node_mask)


class _HEAT(nn.Module):
    """The trunk HEATNet2 and HEATNet4 share: typed input projection, HEAT
    layers, per-type pooling."""

    def __init__(self, in_dim, hidden_dim, n_layers, n_heads, n_node_types,
                 dropout, graph_pooling_type, typed_impl):
        super().__init__()
        self.n_types, self.n_layers = n_node_types, n_layers
        self.graph_pooling_type = graph_pooling_type
        self.typed_impl = typed_impl
        self.adapt_ws = TypedDense(n_node_types, in_dim, hidden_dim,
                                   typed_impl)
        for i in range(n_layers):
            self.add_module(f"gcs_{i}", HEATLayer(
                n_node_types, hidden_dim, hidden_dim, n_heads, dropout,
                typed_impl))

    def trunk(self, g: TypedGraph, drops: Optional[DropSource]):
        pres = _presence(g).type_present.to(g.feat.dtype)
        tsort = (ops.make_type_sort(g.node_type, self.n_types)
                 if self.typed_impl == "ragged" else None)
        h = self.adapt_ws(g.feat, g.node_type, tsort)
        for i in range(self.n_layers):
            h = getattr(self, f"gcs_{i}")(g, h, tsort, drops)
        return pool_all_types(g, h, self.graph_pooling_type), pres


class HEATNet2(_HEAT):
    """Reference HEATNet2: one per-type pooled head on the final features,
    summed over present types."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, n_heads: int, n_node_types: int,
                 dropout: float = 0.2, graph_pooling_type: str = "mean",
                 typed_impl: str = "onehot"):
        super().__init__(in_dim, hidden_dim, n_layers, n_heads, n_node_types,
                         dropout, graph_pooling_type, typed_impl)
        self.linears_prediction = TypedHeads(n_node_types, hidden_dim,
                                             out_dim)

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        pooled, pres = self.trunk(g, drops)
        return (self.linears_prediction(pooled) * pres[:, :, None]).sum(1)


class HEATNet4(_HEAT):
    """Reference HEATNet4, the paper's flagship: per-type 256-d pooled
    embeddings gated by LinearAttentionBlock against their sum,
    concatenated, then a 256*T -> 256 -> 64 -> C head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, n_heads: int, n_node_types: int,
                 dropout: float = 0.2, graph_pooling_type: str = "mean",
                 embed_dim: int = 256, typed_impl: str = "onehot"):
        super().__init__(in_dim, hidden_dim, n_layers, n_heads, n_node_types,
                         dropout, graph_pooling_type, typed_impl)
        t = n_node_types
        self.linears_prediction = TypedHeads(t, hidden_dim, embed_dim)
        for kk in range(t):
            self.add_module(f"attn_{kk}", LinearAttentionBlock(embed_dim))
        self.head_2 = nn.Linear(t * embed_dim, embed_dim)
        self.head_1 = nn.Linear(embed_dim, 64)
        self.head = nn.Linear(64, out_dim)

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        pooled, pres = self.trunk(g, drops)
        out_h = self.linears_prediction(pooled) * pres[:, :, None]
        hg = out_h.sum(1)
        gated = [getattr(self, f"attn_{kk}")(out_h[:, kk], hg)
                 * pres[:, kk, None]
                 for kk in range(self.n_types)]
        x = self.head_2(torch.cat(gated, dim=1))
        return self.head(self.head_1(x))
