"""The readers of the program's spans and counters: each on a made-up
snapshot of the port's registry (profiling.GLOBAL_TIMER) gives the value
its definition says, nothing without a trace or on a program without the
registry, and, in a traced training run on the CPU, what the program's
loaders and trainer recorded."""
import math
import time

import pytest
import torch

from common import load_reader
from conftest import tiny

from wsi_hgnn_tpu_torch import profiling


def span(count, host_s, cpu_s=None, device_s=None):
    return {"count": count, "host_s": host_s, "self_host_s": host_s,
            "cpu_s": host_s if cpu_s is None else cpu_s, "device_s": device_s}


SNAPSHOT = {
    "spans": {
        "loader/read": span(8, 0.4, cpu_s=0.3),
        "loader/pack": span(4, 0.06),
        "loader/wait": span(5, 0.2),
        "loader/to_device": span(4, 0.01),
        "train/step": span(4, 0.1, device_s=0.36),
        "train/step/forward": span(4, 0.03),
        # nested under a caller's span: read by its suffix
        "featurize/chunk": span(3, 0.9),
        "featurize/chunk/encode/hovernet": span(3, 0.05, device_s=0.8),
        "featurize/chunk/encode/kimianet": span(3, 0.01, device_s=0.04),
        "predict/graph": span(1, 0.002, device_s=0.003),
        "predict/model": span(1, 0.004, device_s=0.006),
    },
    "counters": {"loader/starved": {"total": 4, "calls": 4},
                 "featurize/chunk_gap_ns": {"total": 9_000_000, "calls": 2}},
    "dropped": 0,
}
RECORD = {"trace": {"window_s": 1.5}, "traced": {
    "patches": 400, "gnn_sizes": [(400, 3200)]}}
WANT = {
    "loader.read_ms_per_slide": 50.0,
    "loader.read_cpu_share": 75.0,
    "loader.pack_ms_per_batch": 15.0,
    "loader.starved_share": 80.0,
    "trainer.step_host_ms": 25.0,
    "trainer.step_card_ms": 90.0,
    "predictor.hovernet_ms_per_patch": 2.0,
    "predictor.kimianet_ms_per_patch": 0.1,
    "predictor.chunk_gap_ms": 4.5,
    "predictor.graph_ms_per_slide": 3.0,
    "predictor.model_ms_per_slide": 6.0,
}


@pytest.fixture
def snapshot(monkeypatch):
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: SNAPSHOT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_made_up_snapshot(name, snapshot):
    assert load_reader(name)(RECORD) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_a_trace_or_a_registry(
        name, snapshot, monkeypatch):
    read = load_reader(name)
    assert read({}) is None
    assert read({"traced": RECORD["traced"]}) is None
    # the program before the registry: no summed(), no snapshot()
    monkeypatch.delattr(profiling, "summed")
    assert read(RECORD) is None


def test_missing_spans_counters_and_card_times_read_as_nothing(monkeypatch):
    """Off the card device_s is None; a program that opened no span reads
    nothing; no starved fetch reads 0."""
    bare = {"spans": {n: dict(s, device_s=None)
                      for n, s in SNAPSHOT["spans"].items()},
            "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: bare)
    for name in ("trainer.step_card_ms", "predictor.hovernet_ms_per_patch",
                 "predictor.kimianet_ms_per_patch", "predictor.chunk_gap_ms",
                 "predictor.graph_ms_per_slide",
                 "predictor.model_ms_per_slide"):
        assert load_reader(name)(RECORD) is None, name
    assert load_reader("loader.starved_share")(RECORD) == 0.0
    empty = {"spans": {}, "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: empty)
    for name in WANT:
        assert load_reader(name)(RECORD) is None, name


def test_a_traced_training_run_reads_the_loader_and_the_step():
    """hgt-train at a CPU test's size with --trace 1: the loader's and
    the step's readers find the program's spans of the traced sub-window;
    the card's step time is nothing on the CPU."""
    import run as bench_run

    w, c = tiny("hgt-train")
    out = bench_run.run_cell("hgt-train", 7, 1.0, True, torch.device("cpu"),
                             w, c, t_start=time.perf_counter())
    snap = profiling.GLOBAL_TIMER.snapshot()["spans"]
    steps = profiling.summed({"spans": snap}, "train/step")["count"]
    assert steps >= 1
    assert profiling.summed({"spans": snap}, "loader/to_device")["count"] \
        == steps
    for name in ("loader.read_ms_per_slide", "loader.read_cpu_share",
                 "loader.pack_ms_per_batch", "loader.starved_share",
                 "trainer.step_host_ms"):
        value = load_reader(name)(out.record)
        assert value is not None and math.isfinite(value) and value >= 0, name
    assert load_reader("trainer.step_card_ms")(out.record) is None
