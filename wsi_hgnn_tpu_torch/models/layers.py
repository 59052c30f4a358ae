"""Shared model blocks (counterparts in wsi_hgnn_tpu/models/layers.py):
graph readouts, typed linears, per-type LayerNorm, masked BatchNorm,
HEATNet4's gating block, and dropout from an explicit generator.
Parameters keep the flax names and shapes ([T, in, out] kernels, [T, out]
biases), so checkpoints map 1:1 through `convert`."""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..graph import ops
from ..graph.transforms import keep_mask
from ..graph.typed_graph import TypedGraph


class DropSource:
    """Where training-mode dropout gets its keep-masks: drawn from
    `generator` (on its device), or taken in call order from `masks`.
    Every mask used is appended to `used`, so one run's masks can replay
    another (the card against the CPU, or the masks the JAX package
    drew). Semantics of flax nn.Dropout: keep with probability 1 - rate,
    survivors scaled by 1 / (1 - rate); rate 0 is the identity and rate 1
    zeroes."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 masks: Optional[List[torch.Tensor]] = None):
        self.generator = generator
        self.masks = None if masks is None else list(masks)
        self.used: List[torch.Tensor] = []

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        if rate == 1.0:
            return torch.zeros_like(x)
        if self.masks is not None:
            mask = self.masks[len(self.used)].to(x.device)
        elif self.generator is None:
            raise ValueError("training-mode dropout draws from an explicit "
                             "generator; pass a DropSource")
        else:
            mask = keep_mask(x.shape, 1.0 - rate, self.generator)
        self.used.append(mask)
        return torch.where(mask, x / (1.0 - rate), 0.0)


def dropout(module: nn.Module, drops: Optional[DropSource], x: torch.Tensor,
            rate: float) -> torch.Tensor:
    """`x` through dropout at `rate` when `module` is training, else as is;
    a training module with rate > 0 needs `drops`."""
    if not module.training or rate == 0.0:
        return x
    if drops is None:
        raise ValueError("training-mode dropout draws from an explicit "
                         "generator; pass a DropSource")
    return drops(x, rate)


class Pool(nn.Module):
    """Graph readout 'sum' | 'mean' | 'max' | 'att'; 'att' is DGL
    GlobalAttentionPooling with a gate_nn Dense(1)."""

    def __init__(self, kind: str, in_features: int):
        super().__init__()
        if kind not in ("sum", "mean", "max", "att"):
            raise NotImplementedError(f"pooling type {kind!r}")
        self.kind = kind
        if kind == "att":
            self.gate_nn = nn.Linear(in_features, 1)

    def forward(self, g: TypedGraph, feat: torch.Tensor,
                ntype: Optional[int] = None) -> torch.Tensor:
        if self.kind == "sum":
            return ops.readout_sum(g, feat, ntype)
        if self.kind == "mean":
            return ops.readout_mean(g, feat, ntype)
        if self.kind == "max":
            return ops.readout_max(g, feat, ntype)
        return ops.readout_attention(g, feat, self.gate_nn(feat), ntype)


def pool_all_types(g: TypedGraph, feat: torch.Tensor, kind: str
                   ) -> torch.Tensor:
    """[B, T, D] per-(graph, node type) readout."""
    if kind == "mean":
        out = ops.readout_mean_all_types(g, feat)
    elif kind == "sum":
        out = ops.readout_sum_all_types(g, feat)
    elif kind == "max":
        out = ops.readout_max_all_types(g, feat)
    else:
        # 'att' with a per-ntype readout is a TypeError in the reference too
        raise NotImplementedError(f"per-ntype pooling {kind!r}")
    return out.reshape(g.n_graphs, g.n_node_types, -1)


class TypedLayerNorm(nn.Module):
    """One LayerNorm per node type (HGT's per-type norms): scale and bias
    [T, d]."""

    def __init__(self, n_types: int, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(n_types, features))
        self.bias = nn.Parameter(torch.zeros(n_types, features))

    def forward(self, x: torch.Tensor, node_type: torch.Tensor):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return (y * ops.gather(self.scale, node_type)
                + ops.gather(self.bias, node_type))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over real nodes only. Training normalises by the masked
    batch statistics and folds them into the running ones with flax's
    momentum 0.9 (torch's 0.1), the variance as torch's unbiased estimator;
    evaluation uses the running statistics. The buffers `mean` and `var`
    are the flax `batch_stats` leaves of the same names."""

    # leaves that live in flax's batch_stats collection (see convert.py)
    flax_collections = {"mean": "batch_stats", "var": "batch_stats"}

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(x.dtype)[..., None]
            axes = tuple(range(x.dim() - 1))
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum(axes) / cnt
            var = ((x - mean) ** 2 * m).sum(axes) / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_(
                    (1 - self.momentum) * unbiased)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale \
            + self.bias


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
