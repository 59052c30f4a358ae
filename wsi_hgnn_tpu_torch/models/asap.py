"""ASAP select-and-pool and the ASAPGCN classifier (counterparts of
wsi_hgnn_tpu/models/asap.py) on the device form of a TypedGraph.

ASAPPooling (Ranjan et al., AAAI 2020) as the JAX package computes it:
weight-1 self loops replace any self edges; x_pool is a symmetric-
normalised GCN layer aggregating into `src` (the score reads x_pool at
the neighbour); the master query is the per-centre max of incident
x_pool; a GAT-style score is softmaxed per centre (`dst`); the cluster
representation is the score-weighted sum of neighbour features; fitness
is the sigmoid of an LEConv on unit weights; each graph keeps a static
top-K of its real nodes by fitness (ties to the lower index, clusters
past a graph's real-node count marked invalid). The pooled adjacency
S^T·A·S uses the scores with no gradient and is two dense products (the
JAX package computes it outside any Pallas kernel), per graph [K, K]
with the diagonal reset to 1.

Submodule and parameter names are the flax names, so `convert` carries
weights and checkpoints across.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.ops import gather, segment_max, segment_sum
from ..graph.typed_graph import TypedGraph
from .homogeneous import GraphConvLayer
from .layers import DropSource, dropout

_NEG_INF = -1e30


def _with_self_loops(g: TypedGraph, edge_weight: torch.Tensor):
    """Edge arrays extended with one weight-1 self edge per node (masked on
    padding); existing self edges are masked out."""
    n = g.num_nodes
    loop = torch.arange(n, device=g.src.device, dtype=g.src.dtype)
    keep = g.edge_mask & (g.src != g.dst)
    src = torch.cat([g.src, loop])
    dst = torch.cat([g.dst, loop])
    w = torch.cat([edge_weight, edge_weight.new_ones(n)])
    mask = torch.cat([keep, g.node_mask])
    return src, dst, w, mask


def _no_empty(x: torch.Tensor) -> torch.Tensor:
    """A segment maximum with 0 where the segment held no real entry."""
    return torch.where(x <= _NEG_INF / 2, 0.0, x)


class LEConv(nn.Module):
    """Local-extrema convolution, self loops removed:
    deg * lin1(x) + sum_j w_ij (x W)[j] + lin2(x)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Linear(in_features, out_features, bias=False)
        self.lin1 = nn.Linear(in_features, out_features)
        self.lin2 = nn.Linear(in_features, out_features)

    def forward(self, x, src, dst, w, mask):
        n = x.shape[0]
        wk = torch.where(mask & (src != dst), w, 0.0)
        deg = segment_sum(wk, dst, n)
        aggr = segment_sum(wk[:, None] * gather(self.weight(x), src), dst, n)
        return deg[:, None] * self.lin1(x) + aggr + self.lin2(x)


class GCNConv(nn.Module):
    """Symmetric-normalised, edge-weighted GCN layer over an edge list that
    already holds its self loops (PyG GCNConv semantics)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.lin = nn.Linear(in_features, out_features)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, src, dst, w, mask):
        n = x.shape[0]
        wk = torch.where(mask, w, 0.0)
        deg = segment_sum(wk, dst, n)
        inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                               0.0)
        norm = wk * gather(inv_sqrt, src) * gather(inv_sqrt, dst)
        out = segment_sum(norm[:, None] * gather(self.lin(x), src), dst, n)
        return out + self.bias


class ASAPPooling(nn.Module):
    """forward(g, h) -> (pooled [B, K, F], adj [B, K, K], cluster_mask
    [B, K], perm [B, K], fitness [N])."""

    def __init__(self, in_dim: int, k: int, negative_slope: float = 0.2):
        super().__init__()
        self.k = int(k)
        self.negative_slope = negative_slope
        self.gnn_intra_cluster = GCNConv(in_dim, in_dim)
        self.lin_q = nn.Linear(in_dim, in_dim)
        self.gat_att = nn.Linear(2 * in_dim, 1)
        self.gnn_score = LEConv(in_dim, 1)

    def forward(self, g: TypedGraph, h: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        x = g.feat if h is None else h
        n, b, k = g.num_nodes, g.n_graphs, self.k
        # unit weights unless the graph carries an edge weight (the
        # explainers' learned mask); the Pearson sim is not a weight here
        ew = (torch.ones_like(g.sim) if g.edge_weight is None
              else g.edge_weight.to(g.sim.dtype))
        src, dst, w, mask = _with_self_loops(g, ew)

        # aggregated into src: the score below reads x_pool at the neighbour
        x_pool = self.gnn_intra_cluster(x, dst, src, w, mask)

        # master query: per-centre max over incident x_pool
        xs = torch.where(mask[:, None], gather(x_pool, src), _NEG_INF)
        m_q = self.lin_q(_no_empty(segment_max(xs, dst, n)))

        # attention over (centre, neighbour) pairs, softmaxed per centre
        pair = torch.cat([gather(m_q, dst), gather(x_pool, src)], -1)
        score = F.leaky_relu(self.gat_att(pair)[:, 0], self.negative_slope)
        logits = torch.where(mask, score, _NEG_INF)
        zmax = _no_empty(segment_max(logits, dst, n))
        ex = torch.where(mask, torch.exp(logits - gather(zmax, dst)), 0.0)
        denom = segment_sum(ex, dst, n)
        score = ex / gather(denom, dst).clamp_min(1e-16)

        # cluster representation out[i] = sum_j score_ij x_j
        out = segment_sum(score[:, None] * gather(x, src), dst, n)
        fitness = torch.sigmoid(self.gnn_score(
            out, src, dst, torch.ones_like(w), mask)[:, 0])

        # static per-graph top-K: a stable descending sort keeps the lower
        # index first among ties (lax.top_k's order); other graphs' and
        # padding nodes score -1 and mark the slots they fill invalid
        members = g.node_mask[None, :] & (
            g.node_graph[None, :] == torch.arange(b, device=x.device)[:, None])
        f = torch.where(members, fitness.detach()[None, :], -1.0)
        top_vals, perm = torch.sort(f, dim=1, descending=True, stable=True)
        top_vals, perm = top_vals[:, :k], perm[:, :k]
        cluster_mask = top_vals >= 0.0

        flat_perm = perm.reshape(-1)
        flat_valid = cluster_mask.reshape(-1)
        pooled = gather(out, flat_perm) * gather(fitness, flat_perm)[:, None]
        pooled = torch.where(flat_valid[:, None], pooled, 0.0)

        # E = S^T A S, S[j, c] = score of edge (j -> centre c), scores with
        # no gradient. Invalid slots may repeat a node that is another
        # graph's valid centre, so they write to an overflow row/column.
        safe_perm = torch.where(flat_valid, flat_perm, n)
        col_of = torch.full((n + 1,), b * k, dtype=torch.long,
                            device=x.device)
        col_of[safe_perm] = torch.arange(b * k, device=x.device)
        col_of = col_of[:n]
        s_val = torch.where(mask, score, 0.0).detach()
        s_dense = x.new_zeros((n, b * k + 1)).index_put_(
            (src, gather(col_of, dst)), s_val, accumulate=True)[:, :b * k]
        wm = torch.where(mask, w, 0.0)
        m_dense = segment_sum(wm[:, None] * gather(s_dense, src), dst, n)
        e_dense = torch.matmul(s_dense.T, m_dense)          # [BK, BK]
        adj = e_dense.reshape(b, k, b * k)
        adj = torch.stack([adj[gi, :, gi * k:(gi + 1) * k] for gi in range(b)])
        eye = torch.eye(k, dtype=adj.dtype, device=adj.device)
        vm = cluster_mask.to(adj.dtype)
        adj = adj * (1.0 - eye) + eye * vm[:, :, None]
        adj = adj * vm[:, :, None] * vm[:, None, :]
        return pooled.reshape(b, k, -1), adj, cluster_mask, perm, fitness


class DenseGCNBlock(nn.Module):
    """Dense masked GCN layer on [B, K, F] features and a [B, K, K]
    adjacency: adj @ x + x, a linear map, per-row L2 normalisation,
    ReLU, the mask (the JAX package's GCNBlock with use_bn=False,
    relu=True)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Linear(in_features, features)

    def forward(self, x, adj, mask):
        y = self.weight(torch.matmul(adj, x) + x)
        y = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-12)
        return F.relu(y) * mask[:, :, None]


class ASAPGCN(nn.Module):
    """GCN with ASAP pooling (`GNN: name: GCN, graph_pooling_type: asap`):
    a GraphConv stack on the TypedGraph, ASAPPooling to K clusters per
    graph, a dense GCN layer on the pooled adjacency, the masked mean over
    valid clusters, a linear classifier."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, k: int = 32, dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = float(dropout)
        for i in range(n_layers):
            self.add_module(f"conv_{i}", GraphConvLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim, F.relu))
        self.asap = ASAPPooling(hidden_dim, k)
        self.dense_gcn = DenseGCNBlock(hidden_dim, hidden_dim)
        self.classify = nn.Linear(hidden_dim, out_dim)

    def forward(self, g: TypedGraph, drops: Optional[DropSource] = None):
        h = g.feat
        for i in range(self.n_layers):
            if i != 0:
                h = dropout(self, drops, h, self.dropout)
            h = getattr(self, f"conv_{i}")(g, h)
        pooled, adj, cmask, _, _ = self.asap(g, h)
        m = cmask.to(pooled.dtype)
        x = self.dense_gcn(pooled, adj, m)
        hg = (x * m[:, :, None]).sum(1) / m.sum(-1, keepdim=True).clamp_min(1.0)
        return self.classify(hg)
