"""Slide graph construction on the device (counterpart of
wsi_hgnn_tpu/graph/build.py::build_batch_device).

Per slide: KNN over feature space (radius-1 neighbours, L2; the CUDA
kernel on the card, one launch per slide) defines the edges, the Pearson
correlation of the endpoints their sign and weight `sim`, and the
HoVer-Net node types the node heterogeneity. The lattice builder
(models/lattice.py) does the per-slide work; here its [B, N, k] form is
flattened into one batched TypedGraph.
"""
from __future__ import annotations

import torch

from .typed_graph import TypedGraph


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
    emask = lat.emask
    # masked edges get src = dst = 0 within their slide, then the offset
    src = torch.where(emask, torch.arange(n, device=dev)[None, :, None], 0)
    dst = torch.where(emask, lat.idx, 0)
    offsets = torch.arange(b, device=dev)[:, None, None] * n
    src = (src + offsets).reshape(-1)
    dst = (dst + offsets).reshape(-1)
    emask = emask.reshape(-1)
    sim = torch.where(emask, lat.sim.reshape(-1), 0.0)
    esign = torch.where(emask, lat.esign.reshape(-1), 0)
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
