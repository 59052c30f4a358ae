"""Plain MLP baselines (counterpart of wsi_hgnn_tpu/models/mlp.py):
exported, named by no config. Layers are named as flax names them
(Dense_0, Dense_1, ...), so `convert` carries weights across."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_hidden: int):
        super().__init__()
        self.n_layers = n_hidden + 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(
                in_dim if i == 0 else hidden_dim,
                out_dim if i == n_hidden else hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_layers - 1}")(x)


class MLP2Layers(_MLP):
    """relu(Dense(hidden)) then Dense(out)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__(in_dim, hidden_dim, out_dim, 1)


class MLP4Layers(_MLP):
    """Three relu(Dense(hidden)) then Dense(out)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__(in_dim, hidden_dim, out_dim, 3)
