"""K-nearest-neighbour search of one slide (counterpart of
wsi_hgnn_tpu/ops/knn.py).

On a CUDA tensor every route ('exact', 'pallas' and 'approx') runs the
hand-written kernel (kernels/knn.py): it streams candidate tiles, takes
any N and breaks ties to the lower index, so no plain version runs on the
main path and the JAX dispatcher's fall-back at awkward N has nothing to
do. On the CPU the plain versions below run: the dense [N, N] form, or
its streaming form past STREAM_THRESHOLD.

'approx' is the JAX package's `lax.approx_min_k` route (the analog of the
reference's HNSW index). It promises recall >= 0.95 and no order among
equal distances; the port keeps that promise with the exact neighbours
(recall 1, ties to the lower index), as XLA does off the TPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.knn import _select, knn_l2_fused, knn_l2_reference

__all__ = ["STREAM_THRESHOLD", "knn_edges", "knn_l2", "knn_l2_tiled",
           "knn_lookup"]

# Above this node count the [N, N] f32 distance matrix crosses 64 MB, so
# the CPU route streams query stripes instead (the kernel always streams).
STREAM_THRESHOLD = 4096


def knn_l2(features: torch.Tensor, k: int,
           mask: Optional[torch.Tensor] = None, approx: bool = False):
    """(idx [N, k] int32, d2 [N, k] f32), ascending, self excluded; masked
    (False) rows are never candidates. `approx` takes the exact
    neighbours (see the module docstring)."""
    del approx
    return knn_l2_reference(features, k, mask)


def knn_l2_tiled(features: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None, tile: int = 512,
                 approx: bool = False):
    """knn_l2 without the [N, N] matrix: one [tile, N] distance stripe at a
    time, peak memory O(tile*N); the same results as knn_l2, `approx`
    included."""
    del approx
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
    """(idx [N, k] int32, d2 [N, k] f32). impl 'exact' | 'pallas' |
    'approx': the kernel on CUDA, the plain versions on the CPU, the
    exact neighbours for all three."""
    if impl not in ("exact", "approx", "pallas"):
        raise ValueError(f"unknown knn impl {impl!r}")
    if features.device.type == "cuda":
        return knn_l2_fused(features, k, mask)
    if features.shape[0] >= STREAM_THRESHOLD:
        return knn_l2_tiled(features, k, mask)
    return knn_l2(features, k, mask)


def knn_edges(features: torch.Tensor, k: int,
              mask: Optional[torch.Tensor] = None):
    """KNN edge list (src, dst) int32 [N*k]: src is each node repeated k
    times, dst its k nearest neighbours (graph_constructor.py:267-273 of
    the reference); the exact search at any N."""
    idx, _ = knn_lookup(features, k, mask)
    n = features.shape[0]
    src = torch.arange(n, dtype=torch.int32,
                       device=idx.device).repeat_interleave(k)
    return src, idx.reshape(-1)
