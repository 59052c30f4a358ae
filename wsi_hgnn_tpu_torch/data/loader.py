"""Host-side TypedGraph batching (counterpart of
wsi_hgnn_tpu/data/loader.py): `GraphLoader` packs slides into bucketed
batches of a fixed slide count (short tails padded with a zero-weight
repeat of the first slide), edges sorted by the dst-major segment key, on
a background thread; each batch goes to the device once. The shuffle is
np.random.RandomState(seed), the JAX loader's, so both packages visit the
same batches in the same order and pack them array-equal.
`SlideBatches` is the skeleton it shares with `LatticeLoader`.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import profiling
from ..graph.batch import batch_graphs, sort_graph_edges
from ..graph.typed_graph import TypedGraph, bucket_size, repad_graph


def prefetched_batches(batches: Sequence, make_batch, prefetch: int):
    """Yield make_batch(b) for every b, packed on a background thread.

    A worker exception re-raises in the consumer (ending the epoch quietly
    would train on a truncated subset), and a consumer that abandons the
    generator releases the worker. While a profiler runs, each fetch is a
    `loader/wait` span and a fetch that finds the queue empty counts
    `loader/starved`."""
    if prefetch <= 0:
        for b in batches:
            yield make_batch(b)
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()
    cancel = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer has gone: a plain
        # q.put would block the worker forever, pinning packed batches
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not _put(make_batch(b)):
                    return
            _put(stop)
        except BaseException as e:  # handed to the consumer, which raises it
            _put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            if profiling.recording() and q.empty():
                profiling.count("loader/starved")
            with profiling.span("loader/wait"):
                item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()


def stack_graphs(graphs: Sequence[TypedGraph]) -> TypedGraph:
    """Single graphs of one shared capacity stacked on a leading slide
    axis (every array leaf; the metadata of the first)."""
    first = graphs[0]
    leaves = {}
    for name in ("feat", "node_type", "node_graph", "node_mask", "src", "dst",
                 "esign", "sim", "edge_mask", "edge_weight"):
        vals = [getattr(g, name) for g in graphs]
        leaves[name] = None if vals[0] is None else np.stack(vals)
    return first.replace(**leaves)


class SlideBatches:
    """What both training loaders share: the shuffled index batches (the
    JAX loader's np.random.RandomState(seed) order), the read loop, labels
    and weights with short tails padded by a zero-weight repeat of the
    first slide, and the prefetched iteration. A subclass packs the read
    graphs with `_pack(graphs, pad)` (the last `pad` of them repeat the
    first slide) and moves a packed batch to `self.device` with
    `_to_device`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int,
                 prefetch: int, device: Optional[torch.device]):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.device = torch.device("cpu") if device is None else device

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idxs: Sequence[int]):
        """Host numpy batch of the dataset rows `idxs`."""
        graphs: List[TypedGraph] = []
        labels: List[int] = []
        for i in idxs:
            with profiling.span("loader/read", step=int(i)):
                g, y = self.dataset[i]
            graphs.append(g)
            labels.append(int(y))
        pad = self.batch_size - len(graphs)
        weights = [1.0] * len(graphs) + [0.0] * pad
        graphs += [graphs[0]] * pad
        with profiling.span("loader/pack"):
            batch = self._pack(graphs, pad)
        return (batch, np.asarray(labels + [0] * pad, np.int32),
                np.asarray(weights, np.float32))

    def _index_batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        return [list(order[i:i + self.batch_size])
                for i in range(0, len(order), self.batch_size)]

    def __iter__(self) -> Iterator:
        for g, labels, weights in prefetched_batches(
                self._index_batches(), self._make_batch, self.prefetch):
            with profiling.span("loader/to_device"):
                g = self._to_device(g)
            yield g, labels, weights


class GraphLoader(SlideBatches):
    """Yields (TypedGraph on `device`, labels, weights); labels and weights
    stay numpy. Flat batches concatenate the slides into one graph at the
    given (or bucketed) batch capacities; `stacked` batches re-pad every
    slide to the shared PER-SLIDE capacities (required) and stack them on
    a leading axis, for evaluations that run each slide on its own."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, node_capacity: Optional[int] = None,
                 edge_capacity: Optional[int] = None, bucket_base: int = 1024,
                 prefetch: int = 2, sort_edges: bool = True,
                 stacked: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__(dataset, batch_size, shuffle, seed, prefetch, device)
        self.node_capacity = node_capacity
        self.edge_capacity = edge_capacity
        self.bucket_base = bucket_base
        self.sort_edges = sort_edges
        self.stacked = stacked
        if stacked and (node_capacity is None or edge_capacity is None):
            raise ValueError(
                "stacked=True needs explicit per-slide node/edge capacities")

    def _pack(self, graphs: List[TypedGraph], pad: int) -> TypedGraph:
        if self.stacked:
            padded = [repad_graph(g, self.node_capacity, self.edge_capacity)
                      for g in graphs]
            if self.sort_edges:
                padded = [sort_graph_edges(g) for g in padded]
            return stack_graphs(padded)
        gb = batch_graphs(graphs, node_capacity=self.node_capacity,
                          edge_capacity=self.edge_capacity,
                          bucket_base=self.bucket_base)
        return sort_graph_edges(gb) if self.sort_edges else gb

    def _to_device(self, g: TypedGraph) -> TypedGraph:
        return g.to_torch(self.device)


def dataset_capacities(dataset, batch_size: int, bucket_base: int = 1024):
    """Worst-case (node, edge) batch capacities over one scan."""
    max_n = max_e = 0
    for i in range(len(dataset)):
        g = dataset[i][0]
        max_n = max(max_n, int(np.asarray(g.node_mask).sum()))
        max_e = max(max_e, int(np.asarray(g.edge_mask).sum()))
    return (bucket_size(max_n * batch_size, base=bucket_base),
            bucket_size(max_e * batch_size, base=bucket_base))
