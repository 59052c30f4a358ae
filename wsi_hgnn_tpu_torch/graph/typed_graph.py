"""A loaded slide graph on the host, and the size-bucketing policy
(counterpart of the host-side parts of wsi_hgnn_tpu/graph/typed_graph.py:
the `TypedGraph` fields, `bucket_size` and `from_arrays`). numpy only; the
port keeps its own copy so it imports nothing of the JAX package.

A graph is one flat padded structure: nodes `feat[N, D]`, `node_type[N]`,
`node_graph[N]`, `node_mask[N]`; edges `src[E]`, `dst[E]`, `esign[E]`
(0 = negative, 1 = positive Pearson sign), `sim[E]`, `edge_mask[E]`. N and
E are size-bucketed capacities; the canonical relation of an edge is
esign*T*T + src_type*T + dst_type.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TypedGraph:
    """A padded typed slide graph of host numpy arrays."""

    feat: np.ndarray        # [N, D] f32
    node_type: np.ndarray   # [N] int32 in [0, n_node_types); 0 for padding
    node_graph: np.ndarray  # [N] int32 graph id; 0 for padding
    node_mask: np.ndarray   # [N] bool, True for real nodes
    src: np.ndarray         # [E] int32
    dst: np.ndarray         # [E] int32
    esign: np.ndarray       # [E] int32 in {0, 1}
    sim: np.ndarray         # [E] f32 Pearson edge weight
    edge_mask: np.ndarray   # [E] bool, True for real edges
    n_graphs: int = 1
    n_node_types: int = 1
    n_edge_types: int = 2


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
