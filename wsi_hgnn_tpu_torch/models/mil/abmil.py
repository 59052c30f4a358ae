"""ABMIL, attention-based multiple-instance learning (counterpart of
wsi_hgnn_tpu/models/mil/abmil.py): the reference's BClassifier
(linear-ReLU-linear attention over instances, softmax across the bag,
attention-weighted sum, linear classifier) and the gated variant, on one
padded bag with a masked softmax over its instances."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

_NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int) -> torch.Tensor:
    """Softmax along `dim` with padded entries at -1e30, then 0."""
    if mask is None:
        return torch.softmax(scores, dim)
    a = torch.softmax(torch.where(mask, scores, _NEG_INF), dim)
    return torch.where(mask, a, 0.0)


class ABMIL(nn.Module):
    """A = softmax(W2 relu(W1 H)); bag = A @ H; logits = classifier(bag).
    Input [N, D] (+ mask [N]); output [1, num_classes]."""

    def __init__(self, num_classes: int, in_dim: int):
        super().__init__()
        self.attention_0 = nn.Linear(in_dim, in_dim)
        self.attention_1 = nn.Linear(in_dim, 1)
        self.classifier = nn.Linear(in_dim, num_classes)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.attention_1(torch.relu(self.attention_0(feats)))[:, 0]
        a = masked_softmax(a, mask, 0)
        return self.classifier(a @ feats)[None, :]


class GatedABMIL(nn.Module):
    """The reference's GatedAttention core on precomputed features:
    A = w(tanh(V h) * sigmoid(U h)); returns (sigmoid output [1, 1],
    attention [N])."""

    def __init__(self, in_dim: int, hidden_dim: int = 128):
        super().__init__()
        self.attention_V = nn.Linear(in_dim, hidden_dim)
        self.attention_U = nn.Linear(in_dim, hidden_dim)
        self.attention_weights = nn.Linear(hidden_dim, 1)
        self.classifier = nn.Linear(in_dim, 1)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        av = torch.tanh(self.attention_V(feats))
        au = torch.sigmoid(self.attention_U(feats))
        a = masked_softmax(self.attention_weights(av * au)[:, 0], mask, 0)
        return torch.sigmoid(self.classifier(a @ feats))[None, :], a
