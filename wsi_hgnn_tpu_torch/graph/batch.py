"""Host-side graph batching and edge sorting (counterpart of
wsi_hgnn_tpu/graph/batch.py): `dgl.batch` as concatenation with node-index
offsets plus the `node_graph` segment vector, re-padded to a bucketed
capacity. numpy only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .typed_graph import TypedGraph, bucket_size


def sort_graph_edges(g: TypedGraph) -> TypedGraph:
    """Edges sorted by the segment key dst*(ET*T) + esign*T + src_type (the
    grouping of ops.edge_softmax_by_dst_rel), padding edges moved to the
    end with their dst rewritten to the last node slot, so dst stays
    non-decreasing. A stable argsort, the JAX package's own fallback."""
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    esign = np.asarray(g.esign)
    sim = np.asarray(g.sim)
    emask = np.asarray(g.edge_mask)
    node_type = np.asarray(g.node_type)

    t, et = g.n_node_types, g.n_edge_types
    n_combo = et * t
    cap_n = g.num_nodes
    key = dst.astype(np.int64) * n_combo + esign * t + node_type[src]
    key = np.where(emask, key, np.int64(cap_n) * n_combo)
    perm = np.argsort(key, kind="stable")

    dst = np.where(emask, dst, cap_n - 1)
    ew = g.edge_weight
    return g.replace(
        src=src[perm], dst=dst[perm], esign=esign[perm], sim=sim[perm],
        edge_mask=emask[perm],
        edge_weight=None if ew is None else np.asarray(ew)[perm],
        edges_sorted=True)


def batch_graphs(graphs: Sequence[TypedGraph], *,
                 node_capacity: Optional[int] = None,
                 edge_capacity: Optional[int] = None,
                 bucket_base: int = 256) -> TypedGraph:
    """Concatenate padded graphs into one batched TypedGraph: each member's
    padding is dropped and the batch re-padded to a bucketed capacity.
    A member's edge_weight survives batching (ones where a member has
    none)."""
    if not graphs:
        raise ValueError("batch_graphs needs at least one graph")
    t = graphs[0].n_node_types
    et = graphs[0].n_edge_types
    for g in graphs:
        if g.n_node_types != t or g.n_edge_types != et:
            raise ValueError("all graphs in a batch must share type metadata")

    feats, ntys, srcs, dsts, esigns, sims, ews, ngraph = ([] for _ in range(8))
    any_ew = False
    offset = 0
    for i, g in enumerate(graphs):
        n = int(np.asarray(g.node_mask).sum())
        e = int(np.asarray(g.edge_mask).sum())
        feats.append(np.asarray(g.feat)[:n])
        ntys.append(np.asarray(g.node_type)[:n])
        srcs.append(np.asarray(g.src)[:e] + offset)
        dsts.append(np.asarray(g.dst)[:e] + offset)
        esigns.append(np.asarray(g.esign)[:e])
        sims.append(np.asarray(g.sim)[:e])
        ngraph.append(np.full(n, i, dtype=np.int32))
        if g.edge_weight is not None:
            any_ew = True
            ews.append(np.asarray(g.edge_weight)[:e])
        else:
            ews.append(np.ones(e, np.float32))
        offset += n

    n_total = offset
    e_total = sum(len(s) for s in srcs)
    cap_n = node_capacity or bucket_size(n_total, base=bucket_base)
    cap_e = edge_capacity or bucket_size(e_total, base=bucket_base)
    if cap_n < n_total or cap_e < e_total:
        raise ValueError("batch exceeds requested capacity")

    def pad(parts, cap, dtype):
        x = np.concatenate(parts).astype(dtype, copy=False)
        out = np.zeros((cap,) + x.shape[1:], dtype=dtype)
        out[: x.shape[0]] = x
        return out

    return TypedGraph(
        feat=pad(feats, cap_n, np.float32),
        node_type=pad(ntys, cap_n, np.int32),
        # padding nodes point at graph 0 and are masked out of every op
        node_graph=pad(ngraph, cap_n, np.int32),
        node_mask=np.arange(cap_n) < n_total,
        src=pad(srcs, cap_e, np.int32),
        dst=pad(dsts, cap_e, np.int32),
        esign=pad(esigns, cap_e, np.int32),
        sim=pad(sims, cap_e, np.float32),
        edge_mask=np.arange(cap_e) < e_total,
        edge_weight=pad(ews, cap_e, np.float32) if any_ew else None,
        n_graphs=len(graphs), n_node_types=t, n_edge_types=et)
