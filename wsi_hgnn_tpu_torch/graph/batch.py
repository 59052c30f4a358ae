"""Host-side graph batching and edge sorting (counterpart of
wsi_hgnn_tpu/graph/batch.py): `dgl.batch` as concatenation with node-index
offsets plus the `node_graph` segment vector, re-padded to a bucketed
capacity. The native C++ packer and counting sort (`native/`) do the work
by default, as in the JAX package; `native=False` runs the plain numpy
version, which gives the same arrays bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..native import pack_batch_native, sort_edges_native
from .typed_graph import TypedGraph, bucket_size


def sort_graph_edges(g: TypedGraph, native: bool = True) -> TypedGraph:
    """Edges sorted by the segment key dst*(ET*T) + esign*T + src_type (the
    grouping of ops.edge_softmax_by_dst_rel), padding edges moved to the
    end with their dst rewritten to the last node slot, so dst stays
    non-decreasing. The native counting sort, or with native=False a
    stable numpy argsort (the same permutation)."""
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
    pad_key = np.int64(cap_n) * n_combo
    key = np.where(emask, key, pad_key)
    if native:
        perm = sort_edges_native(key, int(pad_key) + 1)
    else:
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
                 bucket_base: int = 256, native: bool = True) -> TypedGraph:
    """Concatenate padded graphs into one batched TypedGraph: each member's
    padding is dropped and the batch re-padded to a bucketed capacity.
    A member's edge_weight survives batching (ones where a member has
    none). native=False packs with numpy instead of the C++ packer."""
    if not graphs:
        raise ValueError("batch_graphs needs at least one graph")
    t = graphs[0].n_node_types
    et = graphs[0].n_edge_types
    for g in graphs:
        if g.n_node_types != t or g.n_edge_types != et:
            raise ValueError("all graphs in a batch must share type metadata")

    feats, ntys, srcs, dsts, esigns, sims, ews = ([] for _ in range(7))
    any_ew = False
    for g in graphs:
        n = int(np.asarray(g.node_mask).sum())
        e = int(np.asarray(g.edge_mask).sum())
        feats.append(np.asarray(g.feat)[:n])
        ntys.append(np.asarray(g.node_type)[:n])
        srcs.append(np.asarray(g.src)[:e])
        dsts.append(np.asarray(g.dst)[:e])
        esigns.append(np.asarray(g.esign)[:e])
        sims.append(np.asarray(g.sim)[:e])
        if g.edge_weight is not None:
            any_ew = True
            ews.append(np.asarray(g.edge_weight)[:e])
        else:
            ews.append(np.ones(e, np.float32))

    n_total = sum(len(f) for f in feats)
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

    if native:
        packed = pack_batch_native(feats, ntys, srcs, dsts, esigns, sims,
                                   cap_n, cap_e)
    else:
        offsets = np.cumsum([0] + [len(f) for f in feats[:-1]])
        packed = (
            pad(feats, cap_n, np.float32), pad(ntys, cap_n, np.int32),
            # padding nodes point at graph 0 and are masked out of every op
            pad([np.full(len(f), i, np.int32) for i, f in enumerate(feats)],
                cap_n, np.int32),
            np.arange(cap_n) < n_total,
            pad([s + o for s, o in zip(srcs, offsets)], cap_e, np.int32),
            pad([d + o for d, o in zip(dsts, offsets)], cap_e, np.int32),
            pad(esigns, cap_e, np.int32), pad(sims, cap_e, np.float32),
            np.arange(cap_e) < e_total)
    feat, ntype, ngraph, nmask, src, dst, esign, sim, emask = packed
    return TypedGraph(
        feat=feat, node_type=ntype, node_graph=ngraph, node_mask=nmask,
        src=src, dst=dst, esign=esign, sim=sim, edge_mask=emask,
        edge_weight=pad(ews, cap_e, np.float32) if any_ew else None,
        n_graphs=len(graphs), n_node_types=t, n_edge_types=et)
