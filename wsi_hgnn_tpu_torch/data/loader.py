"""Background packing of host batches (counterpart of
wsi_hgnn_tpu/data/loader.py::prefetched_batches)."""
from __future__ import annotations

import queue
import threading
from typing import Sequence


def prefetched_batches(batches: Sequence, make_batch, prefetch: int):
    """Yield make_batch(b) for every b, packed on a background thread.

    A worker exception re-raises in the consumer (ending the epoch quietly
    would train on a truncated subset), and a consumer that abandons the
    generator releases the worker."""
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
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
