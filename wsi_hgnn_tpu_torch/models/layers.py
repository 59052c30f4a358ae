"""Typed linears and HEATNet4's gating block (counterparts in
wsi_hgnn_tpu/models/layers.py). Parameters keep the flax shapes,
[T, in, out] kernels and [T, out] biases, so checkpoints map 1:1."""
from __future__ import annotations

import torch
from torch import nn

from ..graph import ops


class TypedDense(nn.Module):
    """One dense map per node type, applied by each row's own type.
    impl 'ragged' (grouped product over type-sorted rows) | 'onehot'."""

    def __init__(self, n_types: int, in_features: int, features: int,
                 impl: str = "onehot"):
        super().__init__()
        if impl not in ("ragged", "onehot"):
            raise ValueError(f"unknown typed impl {impl!r}")
        self.impl = impl
        self.kernel = nn.Parameter(torch.empty(n_types, in_features, features))
        self.bias = nn.Parameter(torch.zeros(n_types, features))

    def forward(self, feat, node_type, tsort=None):
        if self.impl == "ragged":
            return ops.typed_linear_ragged(feat, node_type, self.kernel,
                                           self.bias, tsort)
        return ops.typed_linear(feat, node_type, self.kernel, self.bias)


class TypedHeads(nn.Module):
    """Per-type dense map on per-type readouts: [B, T, D] -> [B, T, F]."""

    def __init__(self, n_types: int, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_types, in_features, features))
        self.bias = nn.Parameter(torch.zeros(n_types, features))

    def forward(self, pooled):
        return torch.einsum("btd,tdo->bto", pooled, self.kernel) + self.bias


class LinearAttentionBlock(nn.Module):
    """HEATNet4's per-type gate. With normalize_attn the softmax runs over
    a singleton axis, so the gate is 1 and the block returns `l`; the
    computation is kept faithful (the `op` weight round-trips)."""

    def __init__(self, features: int, normalize_attn: bool = True):
        super().__init__()
        self.normalize_attn = normalize_attn
        self.op = nn.Linear(features, 1, bias=False)

    def forward(self, l, g):
        c = self.op(l + g)                                    # [B, 1]
        if self.normalize_attn:
            a = torch.softmax(c[:, :, None], dim=2)[:, :, 0]
        else:
            a = torch.sigmoid(c)
        return a * l
