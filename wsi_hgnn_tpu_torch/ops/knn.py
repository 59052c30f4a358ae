"""Exact K-nearest-neighbour search of one slide (counterpart of
wsi_hgnn_tpu/ops/knn.py).

On a CUDA tensor both exact routes ('exact' and 'pallas') run the
hand-written kernel (kernels/knn.py): it streams candidate tiles, takes
any N and breaks ties to the lower index, so no plain version runs on the
main path and the JAX dispatcher's fall-back at awkward N has nothing to
do. On the CPU the plain versions below run: the dense [N, N] form, or
its streaming form past STREAM_THRESHOLD.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.knn import _select, knn_l2_fused
from ..kernels.knn import knn_l2_reference as knn_l2

__all__ = ["STREAM_THRESHOLD", "knn_l2", "knn_l2_tiled", "knn_lookup"]

# Above this node count the [N, N] f32 distance matrix crosses 64 MB, so
# the CPU route streams query stripes instead (the kernel always streams).
STREAM_THRESHOLD = 4096


def knn_l2_tiled(features: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None, tile: int = 512):
    """knn_l2 without the [N, N] matrix: one [tile, N] distance stripe at a
    time, peak memory O(tile*N); the same results as knn_l2."""
    f32 = features.to(torch.float32)
    sq = (f32 * f32).sum(1)
    idx, d2 = [], []
    for s in range(0, f32.shape[0], tile):
        q = f32[s:s + tile]
        stripe = (sq[s:s + tile, None] + sq[None, :] - 2.0 * (q @ f32.T))
        qid = torch.arange(s, s + q.shape[0], device=f32.device)
        i, d = _select(stripe.clamp_min(0.0), qid, mask, k)
        idx.append(i)
        d2.append(d)
    return torch.cat(idx), torch.cat(d2)


def knn_lookup(features: torch.Tensor, k: int,
               mask: Optional[torch.Tensor] = None, impl: str = "exact"):
    """(idx [N, k] int32, d2 [N, k] f32). impl 'exact' | 'pallas' (both
    exact; the kernel on CUDA) | 'approx' (not ported yet)."""
    if impl == "approx":
        raise NotImplementedError(
            "knn impl 'approx' (lax.approx_min_k) is not ported yet; see "
            "ROADMAP.md")
    if impl not in ("exact", "pallas"):
        raise ValueError(f"unknown knn impl {impl!r}")
    if features.device.type == "cuda":
        return knn_l2_fused(features, k, mask)
    if features.shape[0] >= STREAM_THRESHOLD:
        return knn_l2_tiled(features, k, mask)
    return knn_l2(features, k, mask)
