"""The padded slide graph and the size-bucketing policy (counterpart of
wsi_hgnn_tpu/graph/typed_graph.py). The port keeps its own copy so it
imports nothing of the JAX package.

A graph is one flat padded structure: nodes `feat[N, D]`, `node_type[N]`,
`node_graph[N]`, `node_mask[N]`; edges `src[E]`, `dst[E]`, `esign[E]`
(0 = negative, 1 = positive Pearson sign), `sim[E]`, `edge_mask[E]`, and
an optional per-edge message multiplier `edge_weight[E]`. N and E are
size-bucketed capacities; the canonical relation of an edge is
esign*T*T + src_type*T + dst_type. Batching is concatenation plus the
`node_graph` segment vector, so a batch is itself a TypedGraph.

The loaders build and batch graphs as host numpy arrays; `to_torch` moves
a (batched) graph to the device once, index leaves as int64 (the dtype
torch's gathers and scatters index with). The graph methods below run on
that device form.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..collectives import all_reduced


@dataclasses.dataclass(frozen=True)
class TypedGraph:
    """A padded, possibly batched typed graph: host numpy arrays, or
    tensors on a device after `to_torch`."""

    feat: np.ndarray        # [N, D] f32
    node_type: np.ndarray   # [N] int in [0, n_node_types); 0 for padding
    node_graph: np.ndarray  # [N] int graph id; 0 for padding
    node_mask: np.ndarray   # [N] bool, True for real nodes
    src: np.ndarray         # [E] int
    dst: np.ndarray         # [E] int
    esign: np.ndarray       # [E] int in {0, 1}
    sim: np.ndarray         # [E] f32 Pearson edge weight
    edge_mask: np.ndarray   # [E] bool, True for real edges
    # per-edge message multiplier (the explainers' edge mask); None = 1
    edge_weight: Optional[np.ndarray] = None
    n_graphs: int = 1
    n_node_types: int = 1
    n_edge_types: int = 2
    # edges sorted by dst*(ET*T) + esign*T + src_type, padding edges last
    # (graph.batch.sort_graph_edges)
    edges_sorted: bool = False
    # relation and node-type occupancy counted per graph of the batch
    # instead of over the whole batch (as DGL's batched multi_update_all
    # counts it in training), so a flat batch of B graphs computes what B
    # single forwards compute: the explainers' leave-one-out batches
    per_graph_occupancy: bool = False
    # edge sharding (parallel/big_graph.py): a torch.distributed process
    # group when this graph's edge arrays hold only this rank's slice of
    # the edge store (node arrays whole on every rank). Every edge-keyed
    # reduction (graph/ops.py segment softmax and aggregations,
    # rel_edge_counts, degrees) then all-reduces its partial result over
    # the group, so the unmodified models compute the single-device
    # answer. None: the whole edge store is here.
    edge_group: Optional[Any] = None

    def replace(self, **changes) -> "TypedGraph":
        return dataclasses.replace(self, **changes)

    def replace_feat(self, feat) -> "TypedGraph":
        return self.replace(feat=feat)

    @property
    def num_nodes(self) -> int:
        return self.feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def feat_dim(self) -> int:
        return self.feat.shape[1]

    @property
    def n_relations(self) -> int:
        return self.n_edge_types * self.n_node_types * self.n_node_types

    @property
    def is_homogeneous(self) -> bool:
        return self.n_node_types == 1

    # -- on the device form ------------------------------------------- #
    def edge_rel(self) -> torch.Tensor:
        """Canonical relation id per edge (padding edges get some id and
        are excluded by edge_mask)."""
        t = self.n_node_types
        s_ty = self.node_type.index_select(0, self.src)
        d_ty = self.node_type.index_select(0, self.dst)
        return self.esign * (t * t) + s_ty * t + d_ty

    def node_type_counts(self) -> torch.Tensor:
        """[n_graphs * T] real-node count per (graph, node type)."""
        seg = self.node_graph * self.n_node_types + self.node_type
        out = torch.zeros(self.n_graphs * self.n_node_types, dtype=torch.long,
                          device=seg.device)
        return out.index_add_(0, seg, self.node_mask.long())

    def rel_edge_counts(self) -> torch.Tensor:
        """[n_relations] real-edge count per canonical relation over the
        whole (batched) graph: DGL's multi_update_all(cross_reducer=
        'mean') divides by the relations present in the batch."""
        out = torch.zeros(self.n_relations, dtype=torch.long,
                          device=self.src.device)
        out = out.index_add_(0, self.edge_rel(), self.edge_mask.long())
        return self.reduce_edges(out)

    def reduce_edges(self, counts: torch.Tensor) -> torch.Tensor:
        """A count over this graph's edges, summed over `edge_group`
        when the edges are sharded (no autograd: counts of masks)."""
        if self.edge_group is None:
            return counts
        return all_reduced(counts, "sum", self.edge_group)

    def degrees(self, implicit_self_loops: bool = False):
        """(out_degree[N], in_degree[N]) over real edges, in the features'
        float type; `implicit_self_loops` adds 1 to both for real nodes,
        as dgl.add_self_loop would."""
        ones = self.edge_mask.to(self.feat.dtype)
        out_deg = ones.new_zeros(self.num_nodes).index_add_(0, self.src, ones)
        in_deg = ones.new_zeros(self.num_nodes).index_add_(0, self.dst, ones)
        if self.edge_group is not None:
            both = self.reduce_edges(torch.stack([out_deg, in_deg]))
            out_deg, in_deg = both[0], both[1]
        if implicit_self_loops:
            real = self.node_mask.to(ones.dtype)
            out_deg = out_deg + real
            in_deg = in_deg + real
        return out_deg, in_deg

    # -- host -> device --------------------------------------------------- #
    def to_torch(self, device: torch.device) -> "TypedGraph":
        """This (host) graph on `device`: one transfer per leaf, integer
        leaves as int64; leading batch axes (stacked loaders) are kept."""
        from ..utils import to_torch

        def move(a):
            if a is None:
                return None
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.integer):
                return to_torch(a, device, torch.int64)
            return to_torch(a, device)

        leaves = {f.name: move(getattr(self, f.name))
                  for f in dataclasses.fields(self) if f.name in _ARRAYS}
        return self.replace(**leaves)


_ARRAYS = ("feat", "node_type", "node_graph", "node_mask", "src", "dst",
           "esign", "sim", "edge_mask", "edge_weight")


def unstack(g: TypedGraph):
    """The slides of a stacked batch (leaves with a leading slide axis,
    GraphLoader(stacked=True)) as single graphs."""
    b = g.feat.shape[0]
    return [g.replace(**{name: None if getattr(g, name) is None
                         else getattr(g, name)[i] for name in _ARRAYS})
            for i in range(b)]


def bucket_size(n: int, *, base: int = 256) -> int:
    """Next capacity >= n from {base, 1.5*base, 2*base, 3*base, 4*base, ...}:
    two points per octave cap padding waste at ~33%."""
    n = max(int(n), 1)
    cap = base
    while cap < n:
        if cap + cap // 2 >= n:
            return cap + cap // 2
        cap *= 2
    return cap


def from_arrays(
    feat: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    node_type: Optional[np.ndarray] = None,
    esign: Optional[np.ndarray] = None,
    sim: Optional[np.ndarray] = None,
    n_node_types: int = 1,
    n_edge_types: int = 2,
    node_capacity: Optional[int] = None,
    edge_capacity: Optional[int] = None,
    add_self_loops: bool = False,
    bucket_base: int = 256,
) -> TypedGraph:
    """One padded TypedGraph from host arrays. `add_self_loops` appends one
    self-edge per real node after the real edges (esign 1, sim 1), as the
    reference's `dgl.add_self_loop` does for homogeneous graphs."""
    feat = np.asarray(feat, dtype=np.float32)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    n, d = feat.shape
    e = src.shape[0]
    if node_type is None:
        node_type = np.zeros(n, dtype=np.int32)
    if esign is None:
        esign = np.ones(e, dtype=np.int32)
    if sim is None:
        sim = np.ones(e, dtype=np.float32)
    if add_self_loops:
        loop = np.arange(n, dtype=np.int32)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
        esign = np.concatenate([esign, np.ones(n, dtype=np.int32)])
        sim = np.concatenate([sim, np.ones(n, dtype=np.float32)])
        e = e + n

    cap_n = node_capacity or bucket_size(n, base=bucket_base)
    cap_e = edge_capacity or bucket_size(e, base=bucket_base)
    if cap_n < n or cap_e < e:
        raise ValueError(f"capacity too small: nodes {n}>{cap_n} or edges "
                         f"{e}>{cap_e}")

    def pad1(x, cap):
        out = np.zeros((cap,) + x.shape[1:], dtype=x.dtype)
        out[: x.shape[0]] = x
        return out

    return TypedGraph(
        feat=pad1(feat, cap_n),
        node_type=pad1(np.asarray(node_type).astype(np.int32), cap_n),
        node_graph=np.zeros(cap_n, dtype=np.int32),
        node_mask=np.arange(cap_n) < n,
        src=pad1(src, cap_e),
        dst=pad1(dst, cap_e),
        esign=pad1(np.asarray(esign).astype(np.int32), cap_e),
        sim=pad1(np.asarray(sim).astype(np.float32), cap_e),
        edge_mask=np.arange(cap_e) < e,
        n_graphs=1,
        n_node_types=n_node_types,
        n_edge_types=n_edge_types,
    )


def repad_graph(g: TypedGraph, node_capacity: int,
                edge_capacity: int) -> TypedGraph:
    """A single (unbatched) host graph re-padded to the given capacities,
    so slides can be stacked at one shared per-slide capacity."""
    n = int(np.asarray(g.node_mask).sum())
    e = int(np.asarray(g.edge_mask).sum())
    return from_arrays(
        np.asarray(g.feat)[:n], np.asarray(g.src)[:e], np.asarray(g.dst)[:e],
        node_type=np.asarray(g.node_type)[:n],
        esign=np.asarray(g.esign)[:e], sim=np.asarray(g.sim)[:e],
        n_node_types=g.n_node_types, n_edge_types=g.n_edge_types,
        node_capacity=node_capacity, edge_capacity=edge_capacity)


def to_homogeneous(g: TypedGraph) -> TypedGraph:
    """Forget node typing (features, edges and masks kept); host or
    device form."""
    nt = g.node_type
    zeros = (torch.zeros_like(nt) if isinstance(nt, torch.Tensor)
             else np.zeros_like(nt))
    return g.replace(node_type=zeros, n_node_types=1)
