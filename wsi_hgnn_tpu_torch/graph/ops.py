"""Per-node-type linear maps (counterpart of the typed-linear helpers of
wsi_hgnn_tpu/graph/ops.py), differentiable."""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch


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
