"""Vectorised Pearson-correlation edge typing (counterpart of
wsi_hgnn_tpu/ops/pearson.py): the Pearson r of two rows is the cosine of
their centred versions, so every edge needs one normalisation pass plus a
row dot."""
from __future__ import annotations

import torch


def center_normalize(features: torch.Tensor) -> torch.Tensor:
    """Rows centred to zero mean and scaled to unit norm."""
    f = features.to(torch.float32)
    c = f - f.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(c, dim=1, keepdim=True)
    return c / norm.clamp_min(1e-12)


def pearson_sim_at(features: torch.Tensor, idx: torch.Tensor,
                   tile: int = 512) -> torch.Tensor:
    """sim[i, j] = r(features[i], features[idx[i, j]]) without the [N, N]
    gram: one [tile, k, D] neighbour block at a time."""
    fn = center_normalize(features)
    out = []
    for s in range(0, fn.shape[0], tile):
        nb = fn[idx[s:s + tile].long()]                 # [tile, k, D]
        out.append(torch.einsum("qd,qkd->qk", fn[s:s + tile], nb))
    return torch.cat(out)


def pearson_edges(features: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor):
    """(esign [E] int32, sim [E] f32): sim = r of the endpoint rows,
    esign = 1 where r > 0."""
    fn = center_normalize(features)
    sim = (fn[src.long()] * fn[dst.long()]).sum(1)
    return (sim > 0).to(torch.int32), sim
