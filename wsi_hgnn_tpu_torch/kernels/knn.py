"""Exact L2 KNN of one slide: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of wsi_hgnn_tpu/ops/pallas_knn.py::knn_l2_pallas. The kernel
(`csrc/knn.cu`, which says what bounds it and how it is built) streams
candidate tiles through shared memory and keeps a running top-k per
query, so the [N, N] distance matrix never exists; it takes any N.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

KMAX = 32  # csrc/knn.cu keeps at most this many neighbours


def knn_l2_reference(features: torch.Tensor, k: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [N, k] int32, d2 [N, k] f32), ascending, self excluded; masked
    (False) rows are never candidates. The dense form of
    wsi_hgnn_tpu/ops/knn.py::knn_l2: one [N, N] distance matrix and a
    stable sort, so equal distances keep the lower index first."""
    f32 = features.to(torch.float32)
    sq = (f32 * f32).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (f32 @ f32.T)
    return _select(d2.clamp_min(0.0), torch.arange(f32.shape[0],
                                                   device=f32.device),
                   mask, k)


def _select(d2: torch.Tensor, query_ids: torch.Tensor,
            mask: Optional[torch.Tensor], k: int):
    """Mask self and padded candidates to f32 max, then the k smallest of
    each row with ties to the lower candidate index."""
    big = torch.finfo(torch.float32).max
    cand = torch.arange(d2.shape[1], device=d2.device)
    d2 = torch.where(cand[None, :] == query_ids[:, None], big, d2)
    if mask is not None:
        d2 = torch.where(mask.to(torch.bool)[None, :], d2, big)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return idx[:, :k].to(torch.int32), vals[:, :k].contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("knn").knn_l2_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def knn_l2_fused(features: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN of one slide, features [N, D] -> (idx [N, k] int32, d2 [N, k]
    f32). A CUDA tensor launches csrc/knn.cu; a CPU tensor runs
    `knn_l2_reference`. Same results either way, ties included."""
    if features.device.type == "cpu":
        return knn_l2_reference(features, k, mask)
    if features.device.type != "cuda" or features.dim() != 2:
        raise ValueError("knn_l2_fused takes a 2-D CPU or CUDA tensor")
    n, d = features.shape
    if not 1 <= k <= min(KMAX, n):
        raise ValueError(f"k={k} must lie in [1, min({KMAX}, N={n})]")
    dev = features.device
    f32 = features.to(torch.float32).contiguous()
    if mask is None:
        cmask = torch.ones(n, dtype=torch.int32, device=dev)
    else:
        if mask.shape != (n,) or mask.device != dev:
            raise ValueError("mask must be [N] on the features' device")
        cmask = mask.to(torch.int32).contiguous()
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    status = _kernel()(f32.data_ptr(), cmask.data_ptr(), n, d, k,
                       idx.data_ptr(), d2.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "knn_l2_f32")
    knn_l2_fused.launches += 1
    return idx, d2


knn_l2_fused.launches = 0
