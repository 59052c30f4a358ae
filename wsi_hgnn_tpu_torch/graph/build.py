"""Slide graph construction on the device (counterpart of
wsi_hgnn_tpu/graph/build.py::build_batch_device).

Per slide: KNN over feature space (radius-1 neighbours, L2; the CUDA
kernel on the card, one launch per slide) defines the edges, the Pearson
correlation of the endpoints their sign and weight `sim`, and the
HoVer-Net node types the node heterogeneity. The lattice builder
(models/lattice.py) does the per-slide work; here its [B, N, k] form is
flattened into one batched TypedGraph (`build_batch_device`), into one
slide's padded edge list (`build_edges_device`), or cut to one slide's
real edges on the host (`build_graph`, graph construction).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .typed_graph import TypedGraph, bucket_size, from_arrays


def build_edges_device(features: torch.Tensor, radius: int,
                       mask: Optional[torch.Tensor] = None,
                       knn_impl: str = "exact"):
    """(src, dst, esign, sim, edge_mask), each [N*(radius-1)], of one padded
    feature buffer [N, D] on its device: node i's radius-1 KNN edges at
    slots i*k .. i*k+k-1. Self-edges and edges out of or into padding are
    masked, with src = dst = 0, sim 0 and esign 0. src, dst and esign
    are int32, sim f32."""
    from ..models.lattice import build_lattice_device

    n = features.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=features.device)
    lat = build_lattice_device(
        features[None], torch.zeros(1, n, dtype=torch.int64,
                                    device=features.device),
        mask[None].to(torch.bool), radius, knn_impl=knn_impl)
    src, dst, esign, sim, emask = (t[0] for t in _lattice_edges(lat))
    return (src.to(torch.int32), dst.to(torch.int32), esign.to(torch.int32),
            sim, emask)


def _lattice_edges(lat):
    """(src, dst, esign, sim, edge_mask) [B, N*k] of a lattice, src-major
    with slide-local ids; masked slots get src = dst = 0, sim 0, esign
    0."""
    b, n, k = lat.idx.shape
    emask = lat.emask
    src = torch.where(emask, torch.arange(n, device=emask.device
                                          )[None, :, None], 0)
    dst = torch.where(emask, lat.idx, 0)
    sim = torch.where(emask, lat.sim, 0.0)
    esign = torch.where(emask, lat.esign, 0)
    return tuple(t.reshape(b, n * k) for t in (src, dst, esign, sim, emask))


def build_batch_device(features: torch.Tensor, node_types: torch.Tensor,
                       mask: torch.Tensor, radius: int, n_node_types: int = 6,
                       knn_impl: str = "exact",
                       add_self_loops: bool = False) -> TypedGraph:
    """[B, N, D] padded per-slide features (+ types [B, N], mask [B, N])
    -> the batched TypedGraph on their device: [B*N] nodes and
    [B*N*(radius-1)] KNN edges, src-major, edges out of or into padding
    and self-edges masked with src = dst = the slide's node 0, sim 0,
    esign 0.
    `add_self_loops` appends one self-edge per node (esign 1, sim 1,
    masked on padding), as the data layer gives homogeneous graphs."""
    from ..models.lattice import build_lattice_device

    b, n, d = features.shape
    lat = build_lattice_device(features, node_types, mask, radius,
                               n_node_types, knn_impl=knn_impl)
    dev = features.device
    # masked edges get src = dst = 0 within their slide, then the offset
    src, dst, esign, sim, emask = _lattice_edges(lat)
    offsets = torch.arange(b, device=dev)[:, None] * n
    src = (src + offsets).reshape(-1)
    dst = (dst + offsets).reshape(-1)
    esign, sim, emask = esign.reshape(-1), sim.reshape(-1), emask.reshape(-1)
    if add_self_loops:
        loop = torch.arange(b * n, device=dev)
        src = torch.cat([src, loop])
        dst = torch.cat([dst, loop])
        esign = torch.cat([esign, torch.ones_like(loop)])
        sim = torch.cat([sim, torch.ones(b * n, dtype=sim.dtype, device=dev)])
        emask = torch.cat([emask, mask.reshape(-1)])
    return TypedGraph(
        feat=features.reshape(b * n, d),
        node_type=node_types.reshape(-1).long(),
        node_graph=torch.arange(b, device=dev).repeat_interleave(n),
        node_mask=mask.reshape(-1),
        src=src, dst=dst, esign=esign, sim=sim, edge_mask=emask,
        n_graphs=b, n_node_types=n_node_types, n_edge_types=2)


def build_graph(features: np.ndarray, node_types: Optional[np.ndarray],
                radius: int, n_node_types: int = 6,
                node_capacity: Optional[int] = None,
                edge_capacity: Optional[int] = None,
                knn_impl: str = "exact", device=None
                ) -> Tuple[TypedGraph, TypedGraph]:
    """Features [N, D] (+ HoVer-Net node types) -> the padded host pair
    (heterogeneous graph, homogeneous twin) of graph construction, the
    JAX package's build_graph: the edges are built on `device` (one KNN
    launch on the card) from the slide padded to its size bucket, and
    only the real edges come back, src-major. The twin shares edges and
    features and forgets typing."""
    from ..models.lattice import build_lattice_device
    from ..utils import resolve_device, to_numpy, to_torch

    dev = resolve_device(device)
    n = features.shape[0]
    cap_n = node_capacity or bucket_size(n)
    feats_p = np.zeros((1, cap_n, features.shape[1]), np.float32)
    feats_p[0, :n] = features
    mask = np.arange(cap_n)[None] < n
    lat = build_lattice_device(
        to_torch(feats_p, dev), torch.zeros(1, cap_n, dtype=torch.int64,
                                            device=dev),
        to_torch(mask, dev), radius, n_node_types, knn_impl=knn_impl)
    keep = to_numpy(lat.emask[0]).reshape(-1)
    k = radius - 1
    src = np.repeat(np.arange(cap_n, dtype=np.int32), k)[keep]
    dst = to_numpy(lat.idx[0]).reshape(-1).astype(np.int32)[keep]
    esign = to_numpy(lat.esign[0]).reshape(-1).astype(np.int32)[keep]
    sim = to_numpy(lat.sim[0]).reshape(-1)[keep]
    if node_types is None:
        node_types = np.zeros(n, np.int32)
    het = from_arrays(features, src, dst,
                      node_type=np.asarray(node_types, np.int32),
                      esign=esign, sim=sim, n_node_types=n_node_types,
                      node_capacity=cap_n, edge_capacity=edge_capacity)
    homo = from_arrays(features, src, dst, esign=esign, sim=sim,
                       n_node_types=1, node_capacity=cap_n,
                       edge_capacity=edge_capacity)
    return het, homo
