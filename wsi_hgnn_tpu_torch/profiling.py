"""Named-stage wall-clock timing (counterpart of the `StageTimer` of
wsi_hgnn_tpu/profiling.py). Host clock only: on the card a stage that
does not synchronise measures the time to enqueue its work."""
from __future__ import annotations

import contextlib
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


# the process-wide timer the trainer reports its stages to
GLOBAL_TIMER = StageTimer()
