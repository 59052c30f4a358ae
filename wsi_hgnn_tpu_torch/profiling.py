"""Named-stage wall-clock timing and device traces (counterpart of
wsi_hgnn_tpu/profiling.py). `StageTimer` reads the host clock only: on
the card a stage that does not synchronise measures the time to enqueue
its work. `trace` records the host and the card with torch.profiler;
`annotate` names a range in that trace."""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulating named-stage timer; nested stages join names with '/'.

    >>> timer = StageTimer()
    >>> with timer.stage("train/step"): ...
    >>> print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        full = "/".join([*self._stack, name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.add(full, dt)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        """Accumulate externally measured time under an absolute name."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += count

    def report(self) -> str:
        lines = [f"{'stage':<40} {'calls':>6} {'total s':>10} {'mean ms':>10}"]
        for name in sorted(self.totals):
            tot = self.totals[name]
            cnt = self.counts[name]
            lines.append(
                f"{name:<40} {cnt:>6} {tot:>10.3f} {tot / cnt * 1e3:>10.2f}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()


# the process-wide timer the trainer reports its stages to
GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Record CPU and CUDA activity over the block into a trace file in
    `log_dir` (`<host>_<pid>.<time>.pt.trace.json`, which TensorBoard's
    profiler plugin and ui.perfetto.dev open). With create_perfetto_link
    the file's path is logged to open there; nothing is served."""
    import logging

    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(os.listdir(log_dir)) if os.path.isdir(log_dir) else set()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    if create_perfetto_link:
        for name in sorted(set(os.listdir(log_dir)) - before):
            logging.getLogger(__name__).warning(
                "trace written: open %s in https://ui.perfetto.dev",
                os.path.join(log_dir, name))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the trace (torch.profiler's record_function)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
