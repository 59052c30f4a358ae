"""Named-stage timing, spans and device traces (counterpart of
wsi_hgnn_tpu/profiling.py).

One registry, `GLOBAL_TIMER` (a `StageTimer`), holds two kinds of
timing:

* `stage(name)`: always on, the host clock only, accumulated into
  `totals` / `counts` (`report()`). On the card a stage that does not
  synchronise measures the time to enqueue its work.
* `span(name, device=None, step=None)` and `count(name, n=1)`: record
  only while a torch profiler runs (the `--trace 1` window of the
  benchmark, or `trace()` below); otherwise each costs one check of
  torch's module-level profiler flag. A span records its full name (the
  names open on this thread joined by '/'), its parent, its thread, the
  caller's `step` (a slide's index in its dataset, a chunk's in its
  request), `perf_counter_ns` and `thread_time_ns` at both ends, and a
  `record_function("wsi/<full name>")` range, which lies on the
  profiler's clock beside the kernels when the thread is one the
  profiler follows. `device=` a CUDA device also records a pair of
  timing events on that device's current stream, read at `snapshot()`,
  never on the hot path. A stage opened while a profiler runs is
  recorded as a span as well.

`snapshot()` sums the newest profiling session by full name. A session
starts at the first span opened under a profiler after one was opened
without (or when `trace()` is entered) and stamps an anchor: a
zero-length `wsi/anchor` range beside its `perf_counter_ns`, which maps
the records of every thread onto the trace's timeline (torch's profiler
keeps no ranges of a thread that started before it, such as a loader's
prefetch thread). `trace()` writes `<trace file>.spans.json` beside the
trace: every record on the trace's clock and, per span name, the time
the card sat idle inside it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _torch_profiler

PREFIX = "wsi/"
# records kept for the exporter; sums by name go on past it
MAX_RECORDS = 200_000
# device event pairs held unread per name before the finished ones are read
_PENDING = 1024
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler runs (on any thread)."""
    return _torch_profiler._is_profiler_enabled


def _event_stream(device):
    """The stream a device span's events go on, or None off the card."""
    if device is None:
        return None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def _elapsed_s(start, end) -> float:
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


class _Agg:
    """Sums of one span name in the session."""

    __slots__ = ("count", "host_ns", "self_ns", "cpu_ns", "device_s",
                 "pending")

    def __init__(self):
        self.count = self.host_ns = self.self_ns = self.cpu_ns = 0
        self.device_s: Optional[float] = None
        self.pending: List[Tuple] = []

    def read_events(self, block: bool) -> None:
        keep = []
        for start, end in self.pending:
            if block or end.query():
                self.device_s = (self.device_s or 0.0) + _elapsed_s(start, end)
            else:
                keep.append((start, end))
        self.pending = keep


class _Frame:
    """An open stage or span on one thread's stack (the context object;
    `dev_first` / `dev_last`, once closed, are the start and end events
    of its first and last device span, itself included)."""

    __slots__ = ("timer", "name", "full", "parent", "step", "stream",
                 "record", "totals", "session", "t0", "c0", "child_ns",
                 "start", "end", "dev_first", "dev_last", "_rf")

    def __init__(self, timer, name, step, stream, record, totals):
        self.timer, self.name, self.step = timer, name, step
        self.stream, self.record, self.totals = stream, record, totals
        self.start = self.end = self.dev_first = self.dev_last = None

    def __enter__(self):
        timer = self.timer
        stack = timer._stack()
        self.parent = stack[-1] if stack else None
        self.full = (self.name if self.parent is None
                     else f"{self.parent.full}/{self.name}")
        self.child_ns = 0
        if self.record:
            self.session = timer._session_for_span()
            self._rf = _torch_profiler.record_function(PREFIX + self.full)
            self._rf.__enter__()
            if self.stream is not None:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record(self.stream)
                self.dev_first = self.start
            self.c0 = time.thread_time_ns()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        timer = self.timer
        if self.totals:
            timer.add(self.full, (t1 - self.t0) * 1e-9)
        timer._stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += t1 - self.t0
        if not self.record:
            return False
        c1 = time.thread_time_ns()
        if self.stream is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(self.stream)
            self.dev_last = self.end
        self._rf.__exit__(*exc)
        if parent is not None and self.dev_last is not None:
            if parent.dev_first is None:
                parent.dev_first = self.dev_first
            parent.dev_last = self.dev_last
        timer._close(self, t1, c1)
        return False


class StageTimer:
    """Accumulating named-stage timer and span registry; nested stages and
    spans join names with '/' on a stack of their own per thread.

    >>> timer = StageTimer()
    >>> with timer.stage("train/epoch_fetch"): ...
    >>> print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._live = False    # a session is recording
        self._session = 0
        self._clear_session()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    # -- stages (always on) ------------------------------------------------ #
    def stage(self, name: str) -> _Frame:
        """Host-clock stage, accumulated into totals / counts under its
        full name; recorded as a span too while a profiler runs."""
        on = recording()
        if not on:
            self._live = False
        return _Frame(self, name, None, None, on, True)

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

    # -- spans and counters (while a profiler runs) ------------------------ #
    def span(self, name: str, device=None, step: Optional[int] = None):
        """A span (see the module docstring); the context object is the
        open frame, or None when no profiler runs."""
        if not _torch_profiler._is_profiler_enabled:
            self._live = False
            return _OFF
        return _Frame(self, name, step, _event_stream(device), True, False)

    def count(self, name: str, n=1) -> None:
        """Add n to a counter of the session."""
        if not _torch_profiler._is_profiler_enabled:
            self._live = False
            return
        session = self._session_for_span()
        with self._lock:
            if session == self._session:
                c = self._counters[name]
                c[0] += n
                c[1] += 1

    def count_elapsed(self, name: str, start, end) -> None:
        """Add the card's time from event `start` to event `end` (in ns,
        read at snapshot()) to a counter; nothing when either is None."""
        if start is None or end is None or not recording():
            return
        session = self._session_for_span()
        with self._lock:
            if session == self._session:
                self._counters[name][1] += 1
                self._elapsed[name].append((start, end))

    def begin_session(self) -> None:
        """Drop the records of the last session and stamp the anchor."""
        with self._lock:
            self._begin_session()

    def _session_for_span(self) -> int:
        if not self._live:
            with self._lock:
                if not self._live:
                    self._begin_session()
        return self._session

    def _clear_session(self) -> None:
        self._aggs: Dict[str, _Agg] = defaultdict(_Agg)
        self._counters: Dict[str, list] = defaultdict(lambda: [0, 0])
        self._elapsed: Dict[str, list] = defaultdict(list)
        self._records: list = []
        self._dropped = 0
        self.anchor_ns: Optional[int] = None

    def _begin_session(self) -> None:
        self._clear_session()
        self._session += 1
        self._live = True
        t0 = time.perf_counter_ns()
        with _torch_profiler.record_function(PREFIX + "anchor"):
            pass
        self.anchor_ns = (t0 + time.perf_counter_ns()) // 2

    def _close(self, f: _Frame, t1: int, c1: int) -> None:
        host = t1 - f.t0
        with self._lock:
            if f.session != self._session:
                return
            a = self._aggs[f.full]
            a.count += 1
            a.host_ns += host
            a.self_ns += host - f.child_ns
            a.cpu_ns += c1 - f.c0
            if f.stream is not None:
                a.pending.append((f.start, f.end))
                if len(a.pending) > _PENDING:
                    a.read_events(block=False)
            if len(self._records) < MAX_RECORDS:
                self._records.append((
                    f.full, None if f.parent is None else f.parent.full,
                    threading.get_ident(), f.step, f.t0, t1, c1 - f.c0,
                    host - f.child_ns, f.start, f.end))
            else:
                self._dropped += 1

    def snapshot(self) -> Dict:
        """The newest session: {"spans": {full name: {count, host_s,
        self_host_s, cpu_s, device_s}}, "counters": {name: {total,
        calls}}, "dropped": records not kept}. device_s is None for a
        span without device events (any span off the card); a counter
        of card time (count_elapsed) totals ns."""
        with self._lock:
            spans = {}
            for name, a in self._aggs.items():
                a.read_events(block=True)
                spans[name] = {"count": a.count, "host_s": a.host_ns * 1e-9,
                               "self_host_s": a.self_ns * 1e-9,
                               "cpu_s": a.cpu_ns * 1e-9,
                               "device_s": a.device_s}
            for name, pairs in self._elapsed.items():
                self._counters[name][0] += sum(
                    round(_elapsed_s(s, e) * 1e9) for s, e in pairs)
                pairs.clear()
            counters = {k: {"total": v[0], "calls": v[1]}
                        for k, v in self._counters.items()}
            return {"spans": spans, "counters": counters,
                    "dropped": self._dropped}

    def records(self) -> List[Dict]:
        """The session's kept records, in the order they closed: name,
        parent, thread, step, start_ns / end_ns (perf_counter_ns),
        cpu_s, self_host_s, device_s (None without device events)."""
        with self._lock:
            kept = list(self._records)
        return [{"name": name, "parent": parent, "thread": thread,
                 "step": step, "start_ns": t0, "end_ns": t1,
                 "cpu_s": cpu_ns * 1e-9, "self_host_s": self_ns * 1e-9,
                 "device_s": None if start is None else _elapsed_s(start, end)}
                for (name, parent, thread, step, t0, t1, cpu_ns, self_ns,
                     start, end) in kept]

    def export_spans(self, trace_path: str) -> str:
        """Write `<trace_path>.spans.json`: the session's records on the
        trace file's clock (start_us / end_us, mapped through the anchor)
        and, per span name, the card's idle time inside its records
        (`card_idle_s`: the part of them that the trace's kernel, copy and
        memset intervals leave uncovered; None when the trace holds no
        device activity)."""
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        anchor = next((e for e in events if e.get("name") == PREFIX + "anchor"
                       and e.get("ph") == "X"), None)
        if anchor is None or self.anchor_ns is None:
            raise RuntimeError(f"{trace_path} holds no {PREFIX}anchor range")
        offset_us = (anchor["ts"] + 0.5 * anchor.get("dur", 0)
                     - self.anchor_ns * 1e-3)
        busy = _Union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                       if e.get("ph") == "X" and e.get("cat") in
                       ("kernel", "gpu_memcpy", "gpu_memset")])
        snap = self.snapshot()
        records = self.records()
        idle: Dict[str, float] = defaultdict(float)
        for r in records:
            a = r.pop("start_ns") * 1e-3 + offset_us
            b = r.pop("end_ns") * 1e-3 + offset_us
            r["start_us"], r["end_us"] = a, b
            idle[r["name"]] += ((b - a) - busy.covered(a, b)) * 1e-6
        for name, s in snap["spans"].items():
            s["card_idle_s"] = idle[name] if busy.starts else None
        path = trace_path + ".spans.json"
        with open(path, "w") as f:
            json.dump({"anchor": {"perf_counter_ns": self.anchor_ns,
                                  "trace_us": anchor["ts"]},
                       "spans": snap["spans"], "counters": snap["counters"],
                       "dropped": snap["dropped"], "records": records}, f)
        return path


class _Union:
    """The union of intervals, for the covered length of any window."""

    def __init__(self, intervals):
        self.starts, self.ends, self.before = [], [], [0.0]
        for a, b in sorted(intervals):
            if self.ends and a <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], b)
            else:
                self.starts.append(a)
                self.ends.append(b)
        for a, b in zip(self.starts, self.ends):
            self.before.append(self.before[-1] + b - a)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def covered(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a)


# the process-wide registry: the trainer's stages, every span and counter
GLOBAL_TIMER = StageTimer()
span = GLOBAL_TIMER.span
count = GLOBAL_TIMER.count
count_elapsed = GLOBAL_TIMER.count_elapsed


def summed(snapshot: Dict, name: str) -> Optional[Dict]:
    """A snapshot's span sums over every full name that is `name` or ends
    in '/<name>' (a span nested under callers' spans), or None; device_s
    is None unless every such name had device events."""
    hits = [s for full, s in snapshot["spans"].items()
            if full == name or full.endswith("/" + name)]
    if not hits:
        return None
    out = {k: sum(h[k] for h in hits)
           for k in ("count", "host_s", "self_host_s", "cpu_s")}
    dev = [h["device_s"] for h in hits]
    out["device_s"] = None if None in dev else sum(dev)
    return out


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Record CPU and CUDA activity over the block into a trace file in
    `log_dir` (`<host>_<pid>.<time>.pt.trace.json`, which TensorBoard's
    profiler plugin and ui.perfetto.dev open), and the block's spans
    beside it (`<trace file>.spans.json`, StageTimer.export_spans). The
    block runs inside a `wsi/trace` range. With create_perfetto_link the
    trace file's path is logged to open there; nothing is served."""
    import logging

    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(os.listdir(log_dir)) if os.path.isdir(log_dir) else set()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        if torch.cuda.is_available():
            # a kernel of ours first: CUPTI can drop the first kernel it
            # records, which would otherwise be the block's
            torch.ones(1, device="cuda").sum().item()
        GLOBAL_TIMER.begin_session()
        with _torch_profiler.record_function(PREFIX + "trace"):
            yield
    for name in sorted(set(os.listdir(log_dir)) - before):
        path = os.path.join(log_dir, name)
        GLOBAL_TIMER.export_spans(path)
        if create_perfetto_link:
            logging.getLogger(__name__).warning(
                "trace written: open %s in https://ui.perfetto.dev", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the trace (torch.profiler's record_function)."""
    with _torch_profiler.record_function(name):
        yield
