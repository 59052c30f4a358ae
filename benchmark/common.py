"""What every traffic driver shares: seeds, the run context, the profiler
reading, the checks that decide `correct`, and the result line."""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wsi_hgnn_tpu")


def sub_seed(seed: int, tag: str) -> int:
    """A 32-bit seed for one use of the run's seed (`tag` names the use),
    for any whole `seed` >= 0."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 63) - 1), int(seed) >> 63,
                                 zlib.crc32(tag.encode())])
    return int(ss.generate_state(1)[0])


def log_spaced_sizes(lo: int, hi: int, count: int) -> List[int]:
    """`count` sizes spaced evenly in log between lo and hi, both ends
    included: every seed serves this same multiset, in its own order."""
    if count == 1:
        return [int(hi)]
    r = np.exp(np.linspace(np.log(lo), np.log(hi), count))
    return [int(round(x)) for x in r]


def percentile(values, q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.quantile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    cell: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any                 # torch.device
    t_start: float              # perf_counter when the process started
    control: bool = False       # also read the controls (calibration)
    scratch: Optional[Path] = None   # where the run may write files

    @property
    def params(self) -> Dict:
        return self.workload["params"]

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]      # setup_s and the cell's own
    record: Dict[str, Any]            # what the per-layer readers read
    checks: Dict[str, Tuple[float, float]]   # name -> (value, limit)
    memory_peak_bytes: int
    control_checks: Dict[str, float] = dataclasses.field(default_factory=dict)


def free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def checks_from(values: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, Tuple[float, float]]:
    """Each compared number beside its limit from the workload file."""
    return {k: (float(v), float(limits[k])) for k, v in values.items()}


def is_correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(np.isfinite(v) and v <= lim for v, lim in checks.values())


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------
SPAN_PREFIX = "bench/"


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Trace:
    """torch.profiler over a sub-window of the run (CPU and CUDA
    activity). Spans the drivers open with `span()` label the idle gaps.
    `result` reads the device's busy time (the union of kernel and copy
    intervals within the traced window), each kernel's summed time, and
    the longest idle gaps by the innermost benchmark span around them."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._done = None
        self._result: Optional[Dict] = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        _sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._outer = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._outer.__enter__()

    def span(self, name: str):
        import contextlib

        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> None:
        if self.prof is None:
            return
        _sync()
        self._outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self._done, self.prof = self.prof, None

    @property
    def result(self) -> Optional[Dict]:
        """The summary (read after the window: reading it takes seconds)."""
        if self._result is None and self._done is not None:
            self._result = summarize(self._done)
            self._done = None
        return self._result


def summarize(prof) -> Dict:
    from torch.autograd import DeviceType

    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == SPAN_PREFIX + "window"
                  and e.device_type == DeviceType.CPU)
    spans = [(e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):])
             for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith(SPAN_PREFIX)
             and e.name != SPAN_PREFIX + "window"]
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(SPAN_PREFIX)
                 and not getattr(e, "is_user_annotation", False))
    busy, reach = 0.0, window.start
    gaps: List[Tuple[float, float]] = []
    per_name: Dict[str, float] = {}
    for start, end, name in dev:
        per_name[name] = per_name.get(name, 0.0) + (end - start) * 1e-6
        lo, hi = max(start, reach), min(end, window.end)
        if hi > lo:
            if lo > reach:
                gaps.append((reach, lo))
            busy += hi - lo
            reach = hi
    if window.end > reach:
        gaps.append((reach, window.end))

    def label(a, b):
        mid = 0.5 * (a + b)
        inner = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        return min(inner)[1] if inner else "outside the benchmark's spans"

    gap_by_label: Dict[str, float] = {}
    for a, b in gaps:
        key = label(a, b)
        gap_by_label[key] = gap_by_label.get(key, 0.0) + (b - a) * 1e-6
    longest = sorted(((label(a, b), (b - a) * 1e-6) for a, b in gaps),
                     key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (window.end - window.start) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": per_name,
        "n_device_events": len(dev),
        "top_ops": sorted(per_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": longest,
        "idle_by_span": gap_by_label,
    }


def kernel_seconds(trace: Dict, *fragments: str) -> float:
    return sum(s for name, s in trace["kernels"].items()
               if any(f in name for f in fragments))


# ---------------------------------------------------------------------------
# metric readers
# ---------------------------------------------------------------------------
def load_reader(name: str) -> Callable[[Dict], Optional[float]]:
    """metrics/<name>.py's `read(record)`."""
    import importlib.util

    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: end-to-end without trace, per-layer
    with."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_loaded() -> List[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def now() -> float:
    return time.perf_counter()


def emit(result: Dict, checks: Dict[str, Tuple[float, float]]) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard output,
    its checks under the last key."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
