"""The reader of `loader.read_ready_share`: on a made-up snapshot of the
port's registry it gives the ready takes' share, nothing without a
trace, a registry or a take (a program whose loader reads on one
thread counts none), and in a traced training run on the CPU a share
of the program's takes."""
import math
import time

import pytest
import torch

from common import load_reader
from conftest import tiny

from wsi_hgnn_tpu_torch import profiling

NAME = "loader.read_ready_share"
RECORD = {"trace": {"window_s": 1.5}, "traced": {"sizes": [(1000, 8000)]}}


def snapshot(counters):
    return {"spans": {}, "counters": counters, "dropped": 0}


@pytest.mark.parametrize("counters,want", [
    ({"loader/read_ready": {"total": 6, "calls": 6},
      "loader/read_late": {"total": 2, "calls": 2}}, 75.0),
    ({"loader/read_ready": {"total": 5, "calls": 5}}, 100.0),
    ({"loader/read_late": {"total": 3, "calls": 3}}, 0.0),
    ({"loader/starved": {"total": 4, "calls": 4}}, None),
    ({}, None),
])
def test_reader_on_made_up_counters(counters, want, monkeypatch):
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot",
                        lambda: snapshot(counters))
    got = load_reader(NAME)(RECORD)
    assert got == (None if want is None else pytest.approx(want))


def test_reader_finds_nothing_without_a_trace_or_a_registry(monkeypatch):
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: snapshot(
        {"loader/read_ready": {"total": 1, "calls": 1}}))
    read = load_reader(NAME)
    assert read({}) is None
    assert read({"traced": RECORD["traced"]}) is None
    monkeypatch.delattr(profiling, "summed")
    assert read(RECORD) is None


def test_a_traced_training_run_reads_the_takes():
    import run as bench_run

    w, c = tiny("heat4-train")
    out = bench_run.run_cell("heat4-train", 2**31 + 17, 1.0, True,
                             torch.device("cpu"), w, c,
                             t_start=time.perf_counter())
    value = load_reader(NAME)(out.record)
    assert value is not None and math.isfinite(value) and 0 <= value <= 100
