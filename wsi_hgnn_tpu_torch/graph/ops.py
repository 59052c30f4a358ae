"""Segment primitives and per-node-type linear maps (counterpart of
wsi_hgnn_tpu/graph/ops.py), all differentiable.

Every DGL primitive the zoo uses (u_mul_e / v_dot_u messages,
edge_softmax, multi_update_all's cross-type mean, the mean/sum/max/
attention readouts) is a gather, elementwise or GEMM work, and a segment
reduction over the flat padded graph. Gathers are `index_select` (whose
backward is `index_add_`; the backward of a `tensor[index]` gather is a
sorted `index_put_`, PERF.md §5), sums are `index_add`, maxima are
`scatter_reduce(..., "amax", include_self=False)` into a -inf base. Padding
is excluded by masks, and empty segments give what the JAX package's
`jax.ops.segment_*` give after its masks: 0.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from .typed_graph import TypedGraph

_NEG_INF = -1e30


def gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] along the first axis, as index_select."""
    return x.index_select(0, index)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int
                ) -> torch.Tensor:
    out = vals.new_zeros((num,) + vals.shape[1:])
    return out.index_add(0, seg, vals)


def segment_max(vals: torch.Tensor, seg: torch.Tensor, num: int
                ) -> torch.Tensor:
    """Per-segment maximum; an empty segment is -inf (JAX's identity).
    Ties share the gradient evenly, as under JAX."""
    base = vals.new_full((num,) + vals.shape[1:], float("-inf"))
    idx = seg.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return base.scatter_reduce(0, idx, vals, "amax", include_self=False)


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


# --------------------------------------------------------------------- #
# segment softmax
# --------------------------------------------------------------------- #
def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of `scores` ([E] or [E, H]) within each segment. Masked
    entries score -1e30 and get probability 0. The segment max is only a
    stabiliser and carries no gradient (JAX's stop_gradient); a
    non-finite max (an empty segment) becomes 0 and a zero denominator 1."""
    if mask is not None:
        scores = torch.where(_bcast(mask, scores), scores, _NEG_INF)
    with torch.no_grad():
        seg_max = segment_max(scores, segment_ids, num_segments)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(scores - gather(seg_max, segment_ids))
    if mask is not None:
        exp = torch.where(_bcast(mask, exp), exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom > 0, denom, 1.0)
    return exp / gather(denom, segment_ids)


def edge_softmax_by_dst_rel(g: TypedGraph, scores: torch.Tensor
                            ) -> torch.Tensor:
    """Edge softmax per (dst node, canonical relation): DGL's hetero
    models call edge_softmax on each relation subgraph, and the dst node
    pins the dst type, so the group is (dst, esign, src_type). Masked
    edges are pinned to a segment of their own choosing (a running
    maximum of the ids on a sorted graph, the last id otherwise), as the
    JAX package does; they are masked out of the max and the sum."""
    t = g.n_node_types
    n_combo = g.n_edge_types * t
    seg = g.dst * n_combo + g.esign * t + gather(g.node_type, g.src)
    if g.edges_sorted:
        seg = torch.cummax(seg, 0).values
    else:
        seg = torch.where(g.edge_mask, seg, g.num_nodes * n_combo - 1)
    return segment_softmax(scores, seg, g.num_nodes * n_combo,
                           mask=g.edge_mask)


# --------------------------------------------------------------------- #
# message passing aggregation
# --------------------------------------------------------------------- #
def _apply_edge_weight(g: TypedGraph, edge_vals: torch.Tensor
                       ) -> torch.Tensor:
    if g.edge_weight is None:
        return edge_vals
    return edge_vals * _bcast(g.edge_weight, edge_vals)


def copy_e_sum(g: TypedGraph, edge_vals: torch.Tensor) -> torch.Tensor:
    """Sum of per-edge values into their dst nodes: [E, ...] -> [N, ...]."""
    ev = _apply_edge_weight(g, edge_vals)
    ev = torch.where(_bcast(g.edge_mask, ev), ev, 0.0)
    return segment_sum(ev, g.dst, g.num_nodes)


def u_mul_e_sum(g: TypedGraph, node_vals: torch.Tensor,
                edge_vals: torch.Tensor) -> torch.Tensor:
    """DGL fn.u_mul_e -> fn.sum."""
    return copy_e_sum(g, gather(node_vals, g.src) * edge_vals)


def copy_u_sum(g: TypedGraph, node_vals: torch.Tensor) -> torch.Tensor:
    return copy_e_sum(g, gather(node_vals, g.src))


def copy_u_mean(g: TypedGraph, node_vals: torch.Tensor) -> torch.Tensor:
    """Mean over in-edges of the source values; 0 at in-degree 0."""
    s = copy_u_sum(g, node_vals)
    _, in_deg = g.degrees()
    return s / _bcast(in_deg.clamp_min(1.0), s)


def copy_u_max(g: TypedGraph, node_vals: torch.Tensor) -> torch.Tensor:
    """Max over in-edges of the source values; 0 at in-degree 0."""
    msgs = _apply_edge_weight(g, gather(node_vals, g.src))
    msgs = torch.where(_bcast(g.edge_mask, msgs), msgs, _NEG_INF)
    out = segment_max(msgs, g.dst, g.num_nodes)
    return torch.where(out <= _NEG_INF / 2, 0.0, out)


def v_dot_u(g: TypedGraph, dst_vals: torch.Tensor, src_vals: torch.Tensor
            ) -> torch.Tensor:
    """Per-edge <dst_val, src_val> over the last axis ([N, H, D] -> [E, H])."""
    return (gather(dst_vals, g.dst) * gather(src_vals, g.src)).sum(-1)


# --------------------------------------------------------------------- #
# readouts
# --------------------------------------------------------------------- #
def _node_segments(g: TypedGraph, ntype: Optional[int]):
    keep = g.node_mask
    if ntype is not None:
        keep = keep & (g.node_type == ntype)
    return g.node_graph, keep, g.n_graphs


def readout_sum(g: TypedGraph, feat: torch.Tensor,
                ntype: Optional[int] = None) -> torch.Tensor:
    seg, keep, num = _node_segments(g, ntype)
    return segment_sum(torch.where(keep[:, None], feat, 0.0), seg, num)


def readout_mean(g: TypedGraph, feat: torch.Tensor,
                 ntype: Optional[int] = None) -> torch.Tensor:
    """Per-graph mean; a graph with no qualifying node reads out 0."""
    seg, keep, num = _node_segments(g, ntype)
    s = segment_sum(torch.where(keep[:, None], feat, 0.0), seg, num)
    cnt = segment_sum(keep.to(feat.dtype), seg, num)
    return s / cnt.clamp_min(1.0)[:, None]


def readout_max(g: TypedGraph, feat: torch.Tensor,
                ntype: Optional[int] = None) -> torch.Tensor:
    seg, keep, num = _node_segments(g, ntype)
    out = segment_max(torch.where(keep[:, None], feat, _NEG_INF), seg, num)
    return torch.where(out <= _NEG_INF / 2, 0.0, out)


def readout_attention(g: TypedGraph, feat: torch.Tensor,
                      gate_logits: torch.Tensor,
                      ntype: Optional[int] = None) -> torch.Tensor:
    """DGL GlobalAttentionPooling: the gate softmaxed within each graph,
    then the weighted sum."""
    seg, keep, num = _node_segments(g, ntype)
    alpha = segment_softmax(gate_logits.reshape(-1), seg, num, mask=keep)
    vals = torch.where(keep[:, None], feat * alpha[:, None], 0.0)
    return segment_sum(vals, seg, num)


def _type_segments(g: TypedGraph):
    t = g.n_node_types
    return g.node_graph * t + g.node_type, g.n_graphs * t


def readout_mean_all_types(g: TypedGraph, feat: torch.Tensor) -> torch.Tensor:
    """[B*T, D] per-(graph, node type) means in one pass, graph-major;
    empty types read out 0."""
    seg, num = _type_segments(g)
    keep = g.node_mask
    s = segment_sum(torch.where(keep[:, None], feat, 0.0), seg, num)
    cnt = segment_sum(keep.to(feat.dtype), seg, num)
    return s / cnt.clamp_min(1.0)[:, None]


def readout_sum_all_types(g: TypedGraph, feat: torch.Tensor) -> torch.Tensor:
    seg, num = _type_segments(g)
    return segment_sum(torch.where(g.node_mask[:, None], feat, 0.0), seg, num)


def readout_max_all_types(g: TypedGraph, feat: torch.Tensor) -> torch.Tensor:
    seg, num = _type_segments(g)
    out = segment_max(torch.where(g.node_mask[:, None], feat, _NEG_INF),
                      seg, num)
    return torch.where(out <= _NEG_INF / 2, 0.0, out)


# --------------------------------------------------------------------- #
# per-node-type parameter application
# --------------------------------------------------------------------- #


def typed_linear(feat: torch.Tensor, node_type: torch.Tensor,
                 weights: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """y[n] = feat[n] @ W[type[n]] + b[type[n]] via all T products and a
    one-hot select. weights [T, D_in, D_out], biases [T, D_out]."""
    all_out = torch.einsum("nd,tdh->tnh", feat, weights)
    oh = torch.nn.functional.one_hot(node_type.long(), weights.shape[0]
                                     ).to(feat.dtype)
    return torch.einsum("tnh,nt->nh", all_out, oh) + oh @ biases


class TypeSort(NamedTuple):
    """Rows grouped by node type, shared by every typed projection of one
    forward pass. perm sorts rows type-major (stable), inv undoes it;
    offsets[t] is where type t's rows start in sorted order (a host list:
    the one device->host read of a forward)."""

    perm: torch.Tensor
    inv: torch.Tensor
    group_sizes: torch.Tensor
    offsets: List[int]


def make_type_sort(node_type: torch.Tensor, n_types: int) -> TypeSort:
    perm = torch.argsort(node_type, stable=True)
    inv = torch.argsort(perm)
    sizes = torch.bincount(node_type.long(), minlength=n_types)[:n_types]
    offsets = [0] + torch.cumsum(sizes, 0).tolist()
    return TypeSort(perm, inv, sizes, offsets)


def typed_linear_ragged(feat: torch.Tensor, node_type: torch.Tensor,
                        weights: torch.Tensor, biases: torch.Tensor,
                        tsort: Optional[TypeSort] = None) -> torch.Tensor:
    """typed_linear as one product per type over type-sorted rows: 1x the
    FLOPs, no [T, N, H] intermediate; equal to typed_linear up to f32
    reassociation. The per-type products are concatenated in sorted order
    (no `out=` buffer), so autograd runs through them."""
    if tsort is None:
        tsort = make_type_sort(node_type, weights.shape[0])
    xs = feat[tsort.perm]
    parts = [xs[lo:hi] @ weights[t]
             for t, (lo, hi) in enumerate(zip(tsort.offsets[:-1],
                                             tsort.offsets[1:]))
             if hi > lo]
    ys = torch.cat(parts) if parts else feat.new_zeros((0, weights.shape[2]))
    return ys[tsort.inv] + biases[node_type.long()]
