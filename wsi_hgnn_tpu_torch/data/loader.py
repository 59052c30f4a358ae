"""Host-side TypedGraph batching (counterpart of
wsi_hgnn_tpu/data/loader.py): `GraphLoader` packs slides into bucketed
batches of a fixed slide count (short tails padded with a zero-weight
repeat of the first slide), edges sorted by the dst-major segment key, on
a background thread; each batch goes to the device once. Slides are read
ahead on a small pool of threads. The shuffle is
np.random.RandomState(seed), the JAX loader's, so both packages visit the
same batches in the same order and pack them array-equal.
`SlideBatches` is the skeleton it shares with `LatticeLoader`.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
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


# reader threads a loader runs at most: a slide's read is mostly zlib's
# inflate, which runs without the interpreter lock, so reads overlap
MAX_READERS = 4


def reader_count(n_reads: int) -> int:
    """Read threads for an epoch of `n_reads` slides: half the CPUs this
    process may run on, at least 2 and at most MAX_READERS, and no more
    than there are reads."""
    cpus = len(os.sched_getaffinity(0))
    return max(1, min(MAX_READERS, max(2, cpus // 2), n_reads))


class ReadAhead:
    """`read(i)` for every i of `order`, on `readers` threads, submitted
    in that order and taken in it: at most `depth` reads are outstanding
    (submitted and not yet taken), the one being waited for included.
    `take` re-raises a read's exception; `close` cancels the reads not
    started and joins the threads."""

    def __init__(self, read, order: Sequence[int], depth: int, readers: int):
        self._read = read
        self._order = iter(order)
        self._depth = depth
        self._pending: deque = deque()
        # reentrant: a collector that finalizes an abandoned epoch on the
        # thread that holds it may call close() inside _fill
        self._lock = threading.RLock()
        self._closed = False
        self._pool = ThreadPoolExecutor(readers,
                                        thread_name_prefix="slide-read")
        self._fill()

    def _fill(self) -> None:
        with self._lock:
            while not self._closed and len(self._pending) < self._depth:
                i = next(self._order, None)
                if i is None:
                    return
                self._pending.append(self._pool.submit(self._read, i))

    def take(self):
        """The next read's result. While a profiler runs, counts
        `loader/read_ready` if it had finished, else `loader/read_late`."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the slide reads were closed")
            fut = self._pending.popleft()
        profiling.count("loader/read_ready" if fut.done()
                        else "loader/read_late")
        item = fut.result()
        self._fill()
        return item

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)


class SlideBatches:
    """What both training loaders share: the shuffled index batches (the
    JAX loader's np.random.RandomState(seed) order), the slide reads,
    labels and weights with short tails padded by a zero-weight repeat of
    the first slide, and the prefetched iteration. Each epoch reads its
    slides in batch order on a `ReadAhead` pool, at most (prefetch + 1) x
    batch_size + readers of them ahead of the pack. A subclass packs the
    read graphs with `_pack(graphs, pad)` (the last `pad` of them repeat
    the first slide) and moves a packed batch to `self.device` with
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

    def _read(self, i: int):
        with profiling.span("loader/read", step=int(i)):
            return self.dataset[i]

    def _make_batch(self, idxs: Sequence[int],
                    reads: Optional[ReadAhead] = None):
        """Host numpy batch of the dataset rows `idxs`, taken from `reads`
        or, without, read here."""
        graphs: List[TypedGraph] = []
        labels: List[int] = []
        for i in idxs:
            g, y = self._read(i) if reads is None else reads.take()
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
        batches = self._index_batches()
        order = [i for b in batches for i in b]
        readers = reader_count(len(order))
        reads = ReadAhead(self._read, order,
                          (self.prefetch + 1) * self.batch_size + readers,
                          readers)
        try:
            with contextlib.closing(prefetched_batches(
                    batches, lambda idxs: self._make_batch(idxs, reads),
                    self.prefetch)) as it:
                for g, labels, weights in it:
                    with profiling.span("loader/to_device"):
                        g = self._to_device(g)
                    yield g, labels, weights
        finally:
            reads.close()


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
