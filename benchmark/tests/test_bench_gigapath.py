"""The gigapath-train cell: its traffic (traffic/mil_epochs.py), its plain
reference (reference/longnet.py), its readers, and its controls and
planted faults, which must read `correct` false.

On the CPU the cell runs at a test's size (LongNet 64 wide, 2 layers,
segments [16, 32, 64, 128, 256]; 4 slides of 60-300 tiles of 32
features). On the card (`-m gpu`; the file finds the benchmark's modules
itself, so `--noconftest` may be given):

    python3 -m pytest -p no:cacheprovider -q -m gpu benchmark/tests/test_bench_gigapath.py

runs the cell at its own size: the program passes every limit and each
control and fault fails one."""
import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH.parent, BENCH / "loadgen"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import run as bench_run  # noqa: E402
from common import Ctx, is_correct, load_reader  # noqa: E402
from reference import longnet as ref  # noqa: E402
from traffic import mil_epochs  # noqa: E402

from wsi_hgnn_tpu_torch import profiling, train_mil  # noqa: E402

CELL = "gigapath-train"
TINY_MODEL = dict(in_dim=32, dim=64, depth=2, heads=16, mlp_hidden=256,
                  segment_lengths=[16, 32, 64, 128, 256])
FAULTS = ("fp8", "heads_offset0", "mean_merge", "skip_last_layer")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny():
    w, c = bench_run.load_cell(CELL)
    w, c = copy.deepcopy(w), copy.deepcopy(c)
    c["model"].update(TINY_MODEL)
    w["params"].update(slides=4, min_tiles=60, max_tiles=300, feature_dim=32)
    return w, c


def run_tiny(seconds=0.0, control=False, trace=False, seed=2 ** 40 + 7):
    w, c = tiny()
    return bench_run.run_cell(CELL, seed, seconds, trace, torch.device("cpu"),
                              w, c, control=control,
                              t_start=time.perf_counter())


def test_the_window_steps_whole_epochs():
    """With no time at all the window is one whole epoch: every slide
    once, a step each."""
    out = run_tiny(seconds=0.0)
    assert out.attempted == 4 and out.failed == 0
    assert out.record["steps"] == 4
    assert out.end_to_end["train_slides_per_s"] > 0


def test_a_clean_run_is_correct_and_every_control_fails():
    """At the test's size the program passes; fp8 products and each
    planted fault read past a limit; the loss gap is read beside them."""
    out = run_tiny(control=True)
    assert is_correct(out.checks), out.checks
    assert set(out.checks) == {"grad_gap", "change_gap"}
    assert out.record["diag"]["loss_gap"] < 1e-4
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    for name in FAULTS:
        assert any(out.control_checks[f"{name}.{k}"] > lim
                   for k, lim in limits.items()), name
    assert {f"pads_masked.{k}" for k in ("loss_gap", "grad_gap", "change_gap")
            } <= set(out.control_checks)


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    out = run_tiny()
    assert out.checks["change_gap"][0] > out.checks["change_gap"][1]


def test_the_cohort_repeats_from_the_seed():
    """Same seed, same bags; another seed, the same tile counts; labels
    balanced; each blob's `xy` distinct grid cells, row-major, on the
    grid, which train_mil takes (as pixels, x 256, for the model)."""
    w, c = tiny()
    arch = ref.arch_of(c)

    def cohort(seed):
        ctx = Ctx(cell=CELL, workload=w, config=c, seed=seed, seconds=0.0,
                  trace=False, device=torch.device("cpu"), t_start=0.0)
        return mil_epochs.make_cohort(ctx, arch)

    a, b, other = cohort(2 ** 45 + 3), cohort(2 ** 45 + 3), cohort(11)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert np.array_equal(x, y)
    assert a[3] == other[3] and [len(f) for f in a[0]] == a[3]
    assert sorted(np.bincount(a[2])) == [2, 2]
    for cells, px in zip(a[1], train_mil.gigapath_coords(a[1])):
        assert (cells >= 0).all() and (cells < arch["ngrids"]).all()
        assert np.array_equal(px, cells * 256)
        key = cells[:, 1] * arch["ngrids"] + cells[:, 0]
        assert (np.diff(key) > 0).all()


def test_operation_counts():
    """The hand count at the cell's longest slide (T = 32769: the 32768
    pair runs two segments, the second one real row) and, at a test's
    size, torch's flop counter on the reference's forward."""
    from torch.utils.flop_counter import FlopCounterMode

    t, hd = 32769, 48
    pairs = [(33, 1024), (6, 2896), (2, 8192), (1, 4097), (1, 2049)]
    attn = sum(n * 16 * 4 * l * l * hd for n, l in pairs)
    assert ref.attention_flops(t) == attn
    dense = (2 * 32768 * 1536 * 768 + 12 * 2 * t * (4 * 768 ** 2 + 2 * 768 * 3072)
             + 2 * 768 * 2)
    assert ref.forward_flops(t) == dense + 12 * attn
    assert 14.4e12 < ref.forward_flops(t) < 14.6e12
    assert 8.8e12 < 12 * attn < 9.0e12

    _, c = tiny()
    arch = ref.arch_of(c)
    w = ref.make_weights(ref.spec(arch), 1, "cpu")
    n = 150
    x, xy = torch.randn(n, arch["in_dim"]), torch.randint(0, 256 * 40, (n, 2))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.logits(w, x, xy, arch)
    assert fc.get_total_flops() == ref.forward_flops(n + 1, arch)


ARCH = dict(ref.ARCH)
SNAPSHOT = {"spans": {"train/step": {"count": 1, "host_s": 0.2,
                                     "self_host_s": 0.1, "cpu_s": 0.2,
                                     "device_s": 0.4},
                      "train/step/longnet/attn": {"count": 12, "host_s": 0.01,
                                                  "self_host_s": 0.01,
                                                  "cpu_s": 0.01,
                                                  "device_s": 0.1}},
            "counters": {}, "dropped": 0}
RECORD = {"trace": {"window_s": 0.5, "busy_s": 0.45, "n_device_events": 10},
          "traced": {"tokens": [32769]}, "arch": ARCH}


def test_readers_on_a_made_up_record(monkeypatch):
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: SNAPSHOT)
    attn = 12 * ref.attention_flops(32769)
    assert load_reader("trainer.step_card_ms")(RECORD) == pytest.approx(400.0)
    assert load_reader("trainer.step_host_ms")(RECORD) == pytest.approx(200.0)
    assert load_reader("longnet.attn_roofline")(RECORD) == pytest.approx(
        100.0 * attn / 989e12 / 0.1)
    assert load_reader("mfu.train_longnet")(RECORD) == pytest.approx(
        100.0 * 3 * ref.forward_flops(32769) / 989e12 / 0.5)
    assert load_reader("device_idle.train")(RECORD) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["trainer.step_card_ms",
                                  "trainer.step_host_ms",
                                  "longnet.attn_roofline"])
def test_span_readers_find_nothing_without_the_span_or_registry(name,
                                                                monkeypatch):
    """A program without the spans: nothing to read; off the card a span
    has no device time (the host reader still reads); a program before
    the registry has no summed()."""
    read = load_reader(name)
    empty = {"spans": {}, "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: empty)
    assert read(RECORD) is None
    host = {"spans": {k: dict(v, device_s=None)
                      for k, v in SNAPSHOT["spans"].items()},
            "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: host)
    assert (read(RECORD) is None) == (name != "trainer.step_host_ms")
    monkeypatch.delattr(profiling, "summed")
    assert read(RECORD) is None


def test_a_traced_run_records_what_the_readers_read():
    """The traced step is the largest slide's; it holds one `train/step`
    and a `longnet/attn` a layer."""
    out = run_tiny(trace=True)
    assert out.record["traced"]["tokens"] == [300 + 1]
    snap = profiling.GLOBAL_TIMER.snapshot()
    assert profiling.summed(snap, "train/step")["count"] == 1
    assert profiling.summed(snap, "longnet/attn")["count"] == TINY_MODEL["depth"]
    assert load_reader("trainer.step_host_ms")(out.record) > 0


def test_a_program_without_the_model_fails_at_once(monkeypatch):
    """The parent commit's train_mil has no gigapath step: the cell stops
    before its set-up, with an error that names the model."""
    monkeypatch.delattr(train_mil, "gigapath_train_step")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="gigapath"):
        run_tiny()
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.gpu
def test_program_passes_and_every_control_fails_on_the_card(card):
    out = bench_run.run_cell(CELL, 987654321987, 3.0, False, card,
                             control=True, t_start=time.perf_counter())
    assert is_correct(out.checks), out.checks
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    for name in FAULTS:
        assert any(out.control_checks[f"{name}.{k}"] > lim
                   for k, lim in limits.items()), name


def test_the_reference_loads_nothing_of_the_port_or_jax():
    import json
    import subprocess

    code = (f"import json, sys; sys.path[:0] = [{str(BENCH)!r}]; "
            "import reference.longnet; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "wsi_hgnn_tpu",
                        "wsi_hgnn_tpu_torch"}
