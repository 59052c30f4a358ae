"""The uni2h-serve-pixels cell: its traffic (traffic/pixels_whole_cycles.py),
its plain references (reference/vit.py, reference/gat.py), its readers,
and its controls, which must read `correct` false.

On the CPU the cell runs at a test's size (the ViT at width 96, 2 blocks,
a 56-pixel input; the GAT 16 wide); the fp8 control is held to the
cell's limit at the published widths (24 blocks of 1536) on two patches,
where the faults are too. On the card (`-m gpu`; the file finds the
benchmark's modules itself, so `--noconftest` may be given):

    python3 -m pytest -p no:cacheprovider -q -m gpu benchmark/tests/test_bench_uni2h.py

runs the cell at its own size: the program passes every limit and each
control fails its own."""
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

import models  # noqa: E402
import run as bench_run  # noqa: E402
from common import is_correct, load_reader  # noqa: E402
from reference import gat as ref_gat  # noqa: E402
from reference import vit as ref_vit  # noqa: E402

from wsi_hgnn_tpu_torch import convert, profiling, serve  # noqa: E402
from wsi_hgnn_tpu_torch.config import parse_gnn_model  # noqa: E402

CELL = "uni2h-serve-pixels"
TINY_VIT = dict(img_size=56, embed_dim=96, depth=2, num_heads=4,
                mlp_hidden=256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny():
    w, c = bench_run.load_cell(CELL)
    w, c = copy.deepcopy(w), copy.deepcopy(c)
    c["encoder"].update(TINY_VIT)
    c["GNN"].update(in_dim=96, hidden_dim=16, num_heads=2)
    c["pixels"]["chunk"] = 4
    w["params"].update(pool_patches=16, min_patches=10, max_patches=12,
                       sizes=2, warm_buckets=[256], sample_patches=3)
    return w, c


def run_tiny(seconds=0.0, control=False, trace=False, seed=2 ** 40 + 5):
    w, c = tiny()
    return bench_run.run_cell(CELL, seed, seconds, trace, torch.device("cpu"),
                              w, c, control=control,
                              t_start=time.perf_counter())


def test_the_window_serves_whole_cycles():
    """The window closes only at the end of a cycle of the sizes: with no
    time at all, one whole cycle; every cycle the same slides."""
    out = run_tiny(seconds=0.0)
    assert out.record["cycles"] == 1 and out.attempted == 2
    assert out.record["patches"] == 10 + 12
    assert out.end_to_end["px_patches_per_s"] > 0 and out.failed == 0


def test_a_clean_run_is_correct_and_every_control_fails():
    """At the test's size the program passes; the three faults and the
    TF32 graph and GAT each read past their limit (fp8 at this width
    does not: see the published-width test)."""
    out = run_tiny(control=True)
    assert is_correct(out.checks), out.checks
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    for key, value in out.control_checks.items():
        if not key.startswith("fp8."):
            assert value > limits[key.split(".")[-1]], (key, value)


@pytest.fixture
def worker_threads():
    """torch's threads cut to this test worker's share of the cores while
    the test runs (the timed training tests of other workers share
    them)."""
    import os

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def test_fp8_and_the_faults_fail_at_the_published_widths(worker_threads):
    """UNI2-h at its published widths (24 blocks of 1536) on two pool
    patches on the CPU: the fp8 control and each fault read past the
    cell's feat_rel_l2 limit."""
    workload, cfg = bench_run.load_cell(CELL)
    limit = workload["limits"]["feat_rel_l2"]
    arch = ref_vit.arch_of(cfg)
    w = ref_vit.make_weights(ref_vit.spec(arch), 11, "cpu")
    px = torch.from_numpy(models.patch_pool(2, 256, 12, "cpu"))
    want = ref_vit.features(w, px, arch)

    def rel(got):
        return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())

    assert rel(ref_vit.features(w, px, arch, fp8=True)) > limit
    for fault in ref_vit.FAULTS:
        assert rel(ref_vit.features(w, px, arch, fault=fault)) > limit, fault


def test_an_altered_answer_fails(monkeypatch):
    real = serve.SlidePredictor.predict_many

    def altered(self, slides):
        p = real(self, slides)
        return np.clip(p + np.array([0.01, -0.01], np.float32), 0, 1)

    monkeypatch.setattr(serve.SlidePredictor, "predict_many", altered)
    out = run_tiny()
    assert out.checks["prob_gap"][0] > out.checks["prob_gap"][1]


def test_misaligned_features_fail(monkeypatch):
    real = serve.SlidePredictor.featurize

    def altered(self, px):
        f, t = real(self, px)
        return np.roll(f, 1, axis=0), t

    monkeypatch.setattr(serve.SlidePredictor, "featurize", altered)
    out = run_tiny()
    assert out.checks["feat_rel_l2"][0] > out.checks["feat_rel_l2"][1]


def test_gat_spec_is_the_programs_tree():
    _, cfg = bench_run.load_cell(CELL)
    typed, hetero = parse_gnn_model(cfg["GNN"])
    assert not hetero
    want = {p: tuple(np.shape(v)) for p, v in
            models.W.leaves(convert.to_flax_variables(typed))}
    assert {p: s for p, s, _ in ref_gat.spec(cfg["GNN"])} == want


def test_operation_counts():
    """The ViT's frozen count is torch's flop counter's on the reference
    and the hand count; the GAT's by hand at the cell's widths."""
    assert ref_vit.flops_per_patch() == ref_vit.FLOPS_PER_PATCH
    assert ref_vit.hand_flops_per_patch() == ref_vit.FLOPS_PER_PATCH
    _, cfg = bench_run.load_cell(CELL)
    n, e = 1000, 9000
    want = (2.0 * n * 1536 * 2048 + 4.0 * n * 2048 + 2.0 * e * 2048
            + 2.0 * n * 2048 * 2048 + 4.0 * n * 2048 + 2.0 * e * 2048
            + 2.0 * n * 2048 * 2 + 4.0 * n * 2 + 2.0 * e * 2)
    assert ref_gat.forward_flops(n, e, cfg["GNN"]) == want


SNAPSHOT = {"spans": {"featurize/chunk/encode/vit":
                      {"count": 4, "host_s": 0.01, "self_host_s": 0.01,
                       "cpu_s": 0.01, "device_s": 0.5}},
            "counters": {}, "dropped": 0}
RECORD = {"trace": {"window_s": 1.0, "busy_s": 0.9, "n_device_events": 10},
          "traced": {"patches": 1000, "chunks": 4, "chunk": 256,
                     "flops_per_patch": ref_vit.FLOPS_PER_PATCH,
                     "gnn_sizes": [(1000, 9000)],
                     "gnn": {"in_dim": 1536, "hidden_dim": 512, "out_dim": 2,
                             "num_layers": 2, "num_heads": 4,
                             "num_out_heads": 1}}}


def test_readers_on_a_made_up_record(monkeypatch):
    import roofline

    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: SNAPSHOT)
    flops = ref_vit.FLOPS_PER_PATCH
    assert load_reader("predictor.vit_ms_per_patch")(RECORD) == pytest.approx(0.5)
    assert load_reader("vit_roofline")(RECORD) == pytest.approx(
        100.0 * 1024 * flops / 989e12 / 0.5)
    f32 = roofline.knn_ops(1000, 1536) + ref_gat.forward_flops(
        1000, 9000, RECORD["traced"]["gnn"])
    assert load_reader("mfu.serve_vit")(RECORD) == pytest.approx(
        100.0 * (1000 * flops / 989e12 + f32 / 67e12))
    assert load_reader("device_idle.serve_vit")(RECORD) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["predictor.vit_ms_per_patch", "vit_roofline"])
def test_span_readers_find_nothing_without_the_span_or_registry(name,
                                                                monkeypatch):
    """The parent's program has no `encode/vit` span: nothing to read;
    off the card the span has no device time; a program before the
    registry has no summed()."""
    read = load_reader(name)
    empty = {"spans": {}, "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: empty)
    assert read(RECORD) is None
    host = {"spans": {k: dict(v, device_s=None)
                      for k, v in SNAPSHOT["spans"].items()},
            "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiling.GLOBAL_TIMER, "snapshot", lambda: host)
    assert read(RECORD) is None
    monkeypatch.delattr(profiling, "summed")
    assert read(RECORD) is None


def test_a_traced_run_records_what_the_readers_read():
    out = run_tiny(trace=True)
    tc = out.record["traced"]
    assert tc["chunk"] == 4 and tc["chunks"] == -(-tc["patches"] // 4)
    assert tc["gnn_sizes"] == [(tc["patches"], tc["patches"] * 9)]
    snap = profiling.GLOBAL_TIMER.snapshot()
    assert profiling.summed(snap, "encode/vit")["count"] == tc["chunks"]
    # what the cell's older Request readers read: the whole window's
    # featurize time, and the homogeneous branch's graph and model spans
    # of the traced slide (their card time is there on the card only)
    assert load_reader("predictor.featurize_ms_per_patch")(out.record) > 0
    for name in ("predict/graph", "predict/model"):
        assert profiling.summed(snap, name)["count"] == len(tc["gnn_sizes"])


@pytest.mark.gpu
def test_program_passes_and_every_control_fails_on_the_card(card):
    out = bench_run.run_cell(CELL, 987654321987, 3.0, False, card,
                             control=True, t_start=time.perf_counter())
    assert all(v <= lim for v, lim in out.checks.values()), out.checks
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    assert len(out.control_checks) == 5
    for key, value in out.control_checks.items():
        assert value > limits[key.split(".")[-1]], (key, value)


def test_the_new_references_load_nothing_of_the_port_or_jax():
    import json
    import subprocess

    code = (f"import json, sys; sys.path[:0] = [{str(BENCH)!r}]; "
            "import reference.vit, reference.gat; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "wsi_hgnn_tpu",
                        "wsi_hgnn_tpu_torch"}
