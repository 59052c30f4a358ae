"""Homogeneous GNN zoo: GCN, GAT, GIN, NTPoolGCN (counterparts of
wsi_hgnn_tpu/models/homogeneous.py) on the device form of a TypedGraph.

All share the reference's jumping-knowledge readout: the node features
before every conv layer are pooled through a per-layer Dense head, and the
per-layer graph logits are combined (mean for GCN and GAT, sum for GIN).
`forward(g, drops=None)` returns logits [n_graphs, out_dim]; in training
mode dropout takes its masks from `drops` (layers.DropSource), in flax's
call order. Submodule and parameter names are the flax names, so
`convert` carries weights across.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import ops
from ..graph.typed_graph import TypedGraph
from .layers import DropSource, MaskedBatchNorm, Pool, TypedHeads, dropout


class GraphConvLayer(nn.Module):
    """DGL GraphConv, norm='both': D_in^-1/2 A D_out^-1/2 X W + b, zero
    degrees clamped to 1, one bias after the aggregation.
    `implicit_self_loops` adds dgl.add_self_loop's edges without
    materialising them (NTPoolGCN)."""

    def __init__(self, in_features: int, features: int, activation=None,
                 implicit_self_loops: bool = False):
        super().__init__()
        self.activation = activation
        self.implicit_self_loops = implicit_self_loops
        self.weight = nn.Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, g: TypedGraph, h: torch.Tensor) -> torch.Tensor:
        out_deg, in_deg = g.degrees(
            implicit_self_loops=self.implicit_self_loops)
        c_src = torch.rsqrt(out_deg.clamp_min(1.0))
        c_dst = torch.rsqrt(in_deg.clamp_min(1.0))
        msg_in = self.weight(h) * c_src[:, None]
        agg = ops.copy_u_sum(g, msg_in)
        if self.implicit_self_loops:
            agg = agg + torch.where(g.node_mask[:, None], msg_in, 0.0)
        rst = agg * c_dst[:, None] + self.bias
        return rst if self.activation is None else self.activation(rst)


class GCN(nn.Module):
    """Reference GCN: GraphConv stack with pooled per-layer heads, logits
    averaged over the n_layers + 1 heads."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, dropout: float = 0.0,
                 graph_pooling_type: str = "att",
                 implicit_self_loops: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = float(dropout)
        for i in range(n_layers):
            d = in_dim if i == 0 else hidden_dim
            self.add_module(f"pool_{i}", Pool(graph_pooling_type, d))
            self.add_module(f"pred_{i}", nn.Linear(d, out_dim))
            self.add_module(f"conv_{i}", GraphConvLayer(
                d, hidden_dim, F.relu, implicit_self_loops))
        last = in_dim if n_layers == 0 else hidden_dim
        self.add_module(f"pool_{n_layers}", Pool(graph_pooling_type, last))
        self.classify = nn.Linear(last, out_dim)

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        h = g.feat
        outs = []
        for i in range(self.n_layers):
            if i != 0:
                h = dropout(self, drops, h, self.dropout)
            pooled = getattr(self, f"pool_{i}")(g, h)
            outs.append(getattr(self, f"pred_{i}")(pooled))
            h = getattr(self, f"conv_{i}")(g, h)
        pooled = getattr(self, f"pool_{self.n_layers}")(g, h)
        outs.append(self.classify(pooled))
        return torch.stack(outs).mean(0)


class GATConvLayer(nn.Module):
    """DGL GATConv: multi-head additive attention over in-edges with
    feature and attention dropout, optional residual, bias. The residual
    reads the feature-dropped input and is the identity when the widths
    already agree (no res_fc)."""

    def __init__(self, in_features: int, features: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation=None):
        super().__init__()
        self.features, self.num_heads = features, num_heads
        self.feat_drop, self.attn_drop = float(feat_drop), float(attn_drop)
        self.negative_slope = negative_slope
        self.residual = residual
        self.activation = activation
        self.fc = nn.Linear(in_features, num_heads * features, bias=False)
        self.attn_l = nn.Parameter(torch.empty(1, num_heads, features))
        self.attn_r = nn.Parameter(torch.empty(1, num_heads, features))
        if residual and in_features != num_heads * features:
            self.res_fc = nn.Linear(in_features, num_heads * features,
                                    bias=False)
        self.bias = nn.Parameter(torch.zeros(num_heads, features))

    def forward(self, g: TypedGraph, h: torch.Tensor,
                drops: Optional[DropSource] = None) -> torch.Tensor:
        h = dropout(self, drops, h, self.feat_drop)
        z = self.fc(h).reshape(-1, self.num_heads, self.features)
        el = (z * self.attn_l).sum(-1)                       # [N, H]
        er = (z * self.attn_r).sum(-1)
        e = F.leaky_relu(ops.gather(el, g.src) + ops.gather(er, g.dst),
                         self.negative_slope)
        alpha = ops.segment_softmax(e, g.dst, g.num_nodes, mask=g.edge_mask,
                                    group=g.edge_group)
        alpha = dropout(self, drops, alpha, self.attn_drop)
        out = ops.u_mul_e_sum(g, z, alpha[:, :, None])      # [N, H, F]
        if self.residual:
            res = self.res_fc(h) if hasattr(self, "res_fc") else h
            out = out + res.reshape(-1, self.num_heads, self.features)
        out = out + self.bias
        return out if self.activation is None else self.activation(out)


class GAT(nn.Module):
    """Reference GAT: n_layers + 1 GATConv layers with per-layer head
    counts `heads`, heads flattened between layers, pooled per-layer
    heads averaged into the logits. The inner activation is
    leaky_relu(0.01), torch's F.leaky_relu default."""

    def __init__(self, n_layers: int, in_dim: int, hidden_dim: int,
                 out_dim: int, heads: Sequence[int], feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2,
                 residual: bool = False, graph_pooling_type: str = "att"):
        super().__init__()
        self.n_layers = n_layers
        act = lambda x: F.leaky_relu(x, 0.01)  # noqa: E731
        d = in_dim
        for i in range(n_layers + 1):
            last = i == n_layers
            self.add_module(f"pool_{i}", Pool(graph_pooling_type, d))
            self.add_module(f"pred_{i}", nn.Linear(d, out_dim))
            feats = out_dim if last else hidden_dim
            self.add_module(f"gat_{i}", GATConvLayer(
                d, feats, heads[i], feat_drop, attn_drop, negative_slope,
                residual=residual if (last or i != 0) else False,
                activation=None if last else act))
            d = feats * heads[i]

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        h = g.feat
        outs = []
        for i in range(self.n_layers + 1):
            pooled = getattr(self, f"pool_{i}")(g, h)
            outs.append(getattr(self, f"pred_{i}")(pooled))
            h = getattr(self, f"gat_{i}")(g, h, drops).reshape(h.shape[0], -1)
        return torch.stack(outs).mean(0)


class GINMLP(nn.Module):
    """GIN's MLP: Linear -> MaskedBatchNorm -> ReLU between layers."""

    def __init__(self, num_layers: int, in_features: int, hidden_dim: int,
                 output_dim: int):
        super().__init__()
        self.num_layers = num_layers
        if num_layers == 1:
            self.linear = nn.Linear(in_features, output_dim)
            return
        d = in_features
        for i in range(num_layers - 1):
            self.add_module(f"linears_{i}", nn.Linear(d, hidden_dim))
            self.add_module(f"bn_{i}", MaskedBatchNorm(hidden_dim))
            d = hidden_dim
        self.add_module(f"linears_{num_layers - 1}", nn.Linear(d, output_dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.num_layers == 1:
            return self.linear(x)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"linears_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x, mask))
        return getattr(self, f"linears_{self.num_layers - 1}")(x)


class GINConvLayer(nn.Module):
    """DGL GINConv(ApplyNodeFunc(MLP), aggregator, 0, learn_eps):
    (1 + eps) h + aggregate(neighbours), then MLP -> BN -> ReLU."""

    def __init__(self, num_mlp_layers: int, in_features: int,
                 hidden_dim: int, output_dim: int,
                 neighbor_pooling_type: str = "mean",
                 learn_eps: bool = True):
        super().__init__()
        if neighbor_pooling_type not in ("sum", "mean", "max"):
            raise NotImplementedError(neighbor_pooling_type)
        self.neighbor_pooling_type = neighbor_pooling_type
        if learn_eps:
            self.eps = nn.Parameter(torch.zeros(()))
        self.mlp = GINMLP(num_mlp_layers, in_features, hidden_dim, output_dim)
        self.bn = MaskedBatchNorm(output_dim)

    def forward(self, g: TypedGraph, h: torch.Tensor) -> torch.Tensor:
        agg = {"sum": ops.copy_u_sum, "mean": ops.copy_u_mean,
               "max": ops.copy_u_max}[self.neighbor_pooling_type](g, h)
        eps = self.eps if hasattr(self, "eps") else 0.0
        rst = self.mlp((1.0 + eps) * h + agg, g.node_mask)
        return F.relu(self.bn(rst, g.node_mask))


class GIN(nn.Module):
    """Reference GIN: num_layers - 1 GINConv layers, pooled per-layer
    heads, the logits SUMMED. The reference's dropout between layers is
    an AttributeError for num_layers >= 3 (`self.dropout` for
    `self.drop`); the intended final_dropout is applied instead."""

    def __init__(self, input_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, num_mlp_layers: int,
                 final_dropout: float = 0.0, graph_pooling_type: str = "sum",
                 neighbor_pooling_type: str = "mean", learn_eps: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.final_dropout = float(final_dropout)
        d = input_dim
        for i in range(num_layers - 1):
            self.add_module(f"pool_{i}", Pool(graph_pooling_type, d))
            self.add_module(f"pred_{i}", nn.Linear(d, out_dim))
            self.add_module(f"gin_{i}", GINConvLayer(
                num_mlp_layers, d, hidden_dim, hidden_dim,
                neighbor_pooling_type, learn_eps))
            d = hidden_dim
        self.pool_last = Pool(graph_pooling_type, d)
        self.classify = nn.Linear(d, out_dim)

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        h = g.feat
        outs = []
        for i in range(self.num_layers - 1):
            if i != 0:
                h = dropout(self, drops, h, self.final_dropout)
            pooled = getattr(self, f"pool_{i}")(g, h)
            outs.append(getattr(self, f"pred_{i}")(pooled))
            h = getattr(self, f"gin_{i}")(g, h)
        outs.append(self.classify(self.pool_last(g, h)))
        return torch.stack(outs).sum(0)


class NTPoolGCN(nn.Module):
    """Reference NTPoolGCN: GraphConv on the homogeneous view with
    implicit self-loops, per-layer readouts pooled per node type through
    per-type Dense heads, averaged over (layer, present type) pairs. The
    last conv layer's output reaches no head (its weights stay dead, as in
    the reference)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_node_types: int, n_layers: int, dropout: float = 0.0,
                 graph_pooling_type: str = "att"):
        super().__init__()
        if graph_pooling_type not in ("mean", "sum", "max"):
            # 'att' + per-ntype readout is a TypeError in the reference too
            raise NotImplementedError(
                f"per-ntype pooling {graph_pooling_type!r}")
        self.n_types = n_node_types
        self.n_layers = n_layers
        self.out_dim = out_dim
        self.dropout = float(dropout)
        self.graph_pooling_type = graph_pooling_type
        for i in range(n_layers):
            d = in_dim if i == 0 else hidden_dim
            self.add_module(f"pred_{i}", TypedHeads(n_node_types, d, out_dim))
            self.add_module(f"conv_{i}", GraphConvLayer(
                d, hidden_dim, F.relu, implicit_self_loops=True))

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        t = self.n_types
        type_counts = g.node_type_counts().reshape(g.n_graphs, t)
        if not g.per_graph_occupancy:     # over the batch
            type_counts = type_counts.sum(0, keepdim=True)
        present = (type_counts > 0).to(g.feat.dtype)          # [G, T]
        h = g.feat
        hg = g.feat.new_zeros(g.n_graphs, self.out_dim)
        for i in range(self.n_layers):
            if i != 0:
                h = dropout(self, drops, h, self.dropout)
            pooled = _pool_types(g, h, self.graph_pooling_type)
            heads = getattr(self, f"pred_{i}")(pooled.reshape(g.n_graphs, t, -1))
            hg = hg + (heads * present[:, :, None]).sum(1)
            h = getattr(self, f"conv_{i}")(g, h)
        return hg / (self.n_layers * present.sum(-1, keepdim=True)
                     ).clamp_min(1.0)


def _pool_types(g: TypedGraph, h: torch.Tensor, kind: str) -> torch.Tensor:
    return {"mean": ops.readout_mean_all_types,
            "sum": ops.readout_sum_all_types,
            "max": ops.readout_max_all_types}[kind](g, h)
