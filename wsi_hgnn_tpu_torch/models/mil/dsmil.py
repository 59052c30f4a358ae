"""DSMIL, dual-stream MIL (counterpart of wsi_hgnn_tpu/models/mil/
dsmil.py): IClassifier scores every instance; BClassifier takes each
class's highest-scoring ("critical") instance, attends every instance's
query against the critical queries, and classifies the attention-pooled
bag through the reference's per-class Conv1d, which is a per-class inner
product (`fcc_kernel` [C, C, V]). Padding is masked out of the critical
choice and the attention."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..layers import DropSource, dropout
from .abmil import _NEG_INF, masked_softmax


class IClassifier(nn.Module):
    """Per-instance scores on precomputed features (the feature extractor
    is the identity for feature bags)."""

    def __init__(self, num_classes: int, in_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, num_classes)

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return feats, self.fc(feats)


class BClassifier(nn.Module):
    """The bag stream: (logits [1, C], attention [N, C], pooled [C, V])."""

    def __init__(self, num_classes: int, in_dim: int, q_dim: int = 128,
                 dropout_v: float = 0.0):
        super().__init__()
        self.q_dim, self.dropout_v = q_dim, float(dropout_v)
        self.v = nn.Linear(in_dim, in_dim)
        self.q = nn.Linear(in_dim, q_dim)     # shared with the critical query
        self.fcc_kernel = nn.Parameter(torch.empty(num_classes, num_classes,
                                                   in_dim))
        self.fcc_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, feats: torch.Tensor, c: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                drops: Optional[DropSource] = None):
        v = self.v(dropout(self, drops, feats, self.dropout_v))
        q = self.q(feats)
        scores = c if mask is None else torch.where(mask[:, None], c, _NEG_INF)
        crit = torch.argmax(scores, 0)                 # [C] critical instances
        q_max = self.q(feats[crit])                    # [C, Q]
        a = q @ q_max.T / math.sqrt(self.q_dim)        # [N, C]
        a = masked_softmax(a, None if mask is None else mask[:, None], 0)
        b = a.T @ v                                    # [C, V]
        logits = torch.einsum("ocv,cv->o", self.fcc_kernel, b) + self.fcc_bias
        return logits[None, :], a, b


class DSMIL(nn.Module):
    """MILNet: returns (instance logits [N, C], bag logits [1, C], A, B)."""

    def __init__(self, num_classes: int, in_dim: int,
                 dropout_v: float = 0.0):
        super().__init__()
        self.i_classifier = IClassifier(num_classes, in_dim)
        self.b_classifier = BClassifier(num_classes, in_dim,
                                        dropout_v=dropout_v)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                drops: Optional[DropSource] = None):
        feats_o, classes = self.i_classifier(feats)
        bag, a, b = self.b_classifier(feats_o, classes, mask, drops)
        return classes, bag, a, b
