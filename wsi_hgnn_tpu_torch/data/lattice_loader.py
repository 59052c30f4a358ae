"""Lattice-form host batching (counterpart of
wsi_hgnn_tpu/data/lattice_loader.py).

A constructed slide graph gives every node k = radius-1 KNN out-edges, so
it packs into the [B, N, k] `LatticeGraph` form; graphs with shorter rows
(imports where a neighbour is missing) pack too, their empty slots masked
by emask. `probe_lattice_and_capacities` scans a dataset once and returns
the shared lattice geometry iff every graph packs and the padding stays
within `max_pad_ratio`; `probe_lattice` is that probe alone.

Batches are packed as numpy on a background thread and go to the device
once per batch (`utils.to_torch`), index leaves as int64.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..graph.typed_graph import TypedGraph, bucket_size
from ..models.lattice import LatticeGraph
from ..utils import to_torch
from .loader import SlideBatches


def slide_lattice_geometry(
    g: TypedGraph, n: Optional[int] = None, e: Optional[int] = None,
) -> Optional[Tuple[int, int, int]]:
    """(max out-degree, real edges, real nodes) if the single graph packs
    into the masked lattice form, else None (no nodes or edges, or an
    endpoint outside the real nodes, which would clamp in the gathers)."""
    if n is None:
        n = int(np.asarray(g.node_mask).sum())
    if e is None:
        e = int(np.asarray(g.edge_mask).sum())
    if n == 0 or e == 0:
        return None
    src = np.asarray(g.src)[:e]
    dst = np.asarray(g.dst)[:e]
    if (src.max(initial=0) >= n or src.min(initial=0) < 0
            or dst.max(initial=0) >= n or dst.min(initial=0) < 0):
        return None
    counts = np.bincount(src, minlength=n)
    return int(counts.max()), e, n


def slide_regular_k(g: TypedGraph) -> Optional[int]:
    """k if the single graph is k-regular in out-degree, else None."""
    geo = slide_lattice_geometry(g)
    if geo is None:
        return None
    k, e, n = geo
    return k if e == n * k else None


def probe_lattice(dataset, max_pad_ratio: float = 1.5
                  ) -> Optional[Tuple[int, int]]:
    """(k, lattice node capacity) if every graph of the dataset packs into
    one shared [N, k] masked lattice, else None."""
    return probe_lattice_and_capacities(dataset, 1,
                                        max_pad_ratio=max_pad_ratio)[2]


def probe_lattice_and_capacities(dataset, batch_size: int,
                                 bucket_base: int = 1024,
                                 max_pad_ratio: float = 1.5):
    """(cap_n, cap_e, lattice_probe) in one dataset scan; lattice_probe is
    (k, lattice node capacity) or None. k is the dataset's largest
    out-degree; the probe accepts while sum(n_i) * k <= max_pad_ratio *
    sum(e_i)."""
    k = 0
    packable = True
    max_n = max_e = 0
    sum_n = sum_e = 0
    for i in range(len(dataset)):
        g = dataset[i][0]
        n = int(np.asarray(g.node_mask).sum())
        e = int(np.asarray(g.edge_mask).sum())
        max_n = max(max_n, n)
        max_e = max(max_e, e)
        if packable:
            geo = slide_lattice_geometry(g, n=n, e=e)
            if geo is None:
                packable = False
            else:
                k = max(k, geo[0])
                sum_e += geo[1]
                sum_n += geo[2]
    probe = None
    if packable and k and sum_n * k <= max_pad_ratio * sum_e:
        probe = (k, bucket_size(max_n))
    return (
        bucket_size(max_n * batch_size, base=bucket_base),
        bucket_size(max_e * batch_size, base=bucket_base),
        probe,
    )


def lattice_batch_for_budget(k: int, cap_n: int, budget: int = 2 << 30,
                             max_batch: int = 8) -> Optional[int]:
    """Largest batch (<= max_batch) whose [B, N*k, N] f32 one-hot
    destination matrix fits `budget` bytes, or None when B = 1 does not
    (or k < 1). The port builds no such matrix; the JAX package's trainer
    and predictor choose between the lattice and the TypedGraph path by
    it, and the port makes the same choice."""
    if k < 1:
        return None
    per = cap_n * k * cap_n * 4
    if per > budget:
        return None
    return max(1, min(max_batch, int(budget // per)))


def pack_slide(g: TypedGraph, k: int, cap_n: int):
    """One graph with out-degrees <= k -> per-slide lattice buffers
    [cap_n, ...]. Edges are grouped by source, stable within a source, so
    the j-th out-edge of node i lands at (i, j); short rows leave their
    tail slots emask=False (idx 0)."""
    n = int(np.asarray(g.node_mask).sum())
    e = int(np.asarray(g.edge_mask).sum())
    src = np.asarray(g.src)[:e]
    order = np.argsort(src, kind="stable")
    s = src[order]
    slot = np.arange(e) - np.searchsorted(s, s, side="left")
    if e and int(slot.max()) >= k:
        raise ValueError(
            f"pack_slide: out-degree {int(slot.max()) + 1} exceeds lattice "
            f"k={k} (the probe must gate packing)")

    feats = np.zeros((cap_n, g.feat.shape[1]), np.float32)
    ntypes = np.zeros(cap_n, np.int32)
    mask = np.zeros(cap_n, bool)
    idx = np.zeros((cap_n, k), np.int32)
    sim = np.zeros((cap_n, k), np.float32)
    esign = np.zeros((cap_n, k), np.int32)
    emask = np.zeros((cap_n, k), bool)

    feats[:n] = np.asarray(g.feat)[:n]
    ntypes[:n] = np.asarray(g.node_type)[:n]
    mask[:n] = True
    idx[s, slot] = np.asarray(g.dst)[order]
    sim[s, slot] = np.asarray(g.sim)[order]
    esign[s, slot] = np.asarray(g.esign)[order]
    emask[s, slot] = True
    return feats, ntypes, mask, idx, sim, esign, emask


def lattice_to_torch(g: LatticeGraph, device: torch.device) -> LatticeGraph:
    """A numpy LatticeGraph on `device`: one transfer per leaf, integer
    leaves as int64 (the dtype torch's gathers and scatters index with)."""
    return LatticeGraph(*(
        to_torch(a, device, torch.int64 if np.issubdtype(a.dtype, np.integer)
                 else None) for a in g))


class LatticeLoader(SlideBatches):
    """Yields (LatticeGraph [B, N, k] on `device`, labels, weights); labels
    and weights stay numpy. Short tail batches repeat the first slide at
    weight 0, so every batch has one shape. The shuffle is
    np.random.RandomState(seed), the JAX loader's, so both packages visit
    batches in the same order."""

    def __init__(self, dataset, batch_size: int, k: int, node_capacity: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 device: Optional[torch.device] = None):
        super().__init__(dataset, batch_size, shuffle, seed, prefetch, device)
        self.k = k
        self.node_capacity = node_capacity

    def _pack(self, graphs: List[TypedGraph], pad: int) -> LatticeGraph:
        slides = [pack_slide(g, self.k, self.node_capacity)
                  for g in graphs[:len(graphs) - pad]]
        slides += [slides[0]] * pad    # the first slide packed once
        return LatticeGraph(*[np.stack(p) for p in zip(*slides)])

    def _to_device(self, g: LatticeGraph) -> LatticeGraph:
        return lattice_to_torch(g, self.device)
