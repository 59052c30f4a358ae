"""The port's tracing registry (wsi_hgnn_tpu_torch/profiling.py) and the
spans the loaders, the trainer and the predictor open, on the CPU: spans
and counters record only under a torch profiler, with full names, parents
and self time on a stack of each thread's own; a thread the profiler does
not follow is mapped onto the trace through the anchor; a new profiling
session replaces the last."""
import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wsi_hgnn_tpu_torch import convert, profiling
from wsi_hgnn_tpu_torch.config import parse_gnn_model
from wsi_hgnn_tpu_torch.data.datasets import GraphDataset, save_graph_npz
from wsi_hgnn_tpu_torch.data.lattice_loader import (
    LatticeLoader, probe_lattice_and_capacities)
from wsi_hgnn_tpu_torch.data.loader import GraphLoader
from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
from wsi_hgnn_tpu_torch.profiling import GLOBAL_TIMER, span
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.train.trainer import GNNTrainer
import port_threads  # noqa: F401  (torch threads per test worker)

D, RADIUS = 16, 4
GNNS = {
    "heat4": {"name": "HEAT4", "n_node_types": 6, "num_layers": 2,
              "in_dim": D, "hidden_dim": 16, "out_dim": 2, "n_heads": 2,
              "feat_drop": 0.2, "graph_pooling_type": "mean"},
    "hgt": {"name": "HGT", "n_node_types": 6, "edge_types": ["pos", "neg"],
            "num_meta_paths": 3, "num_layers": 2, "in_dim": D,
            "hidden_dim": 16, "out_dim": 2, "num_heads": 2,
            "num_out_heads": 1, "feat_drop": 0.2,
            "graph_pooling_type": "mean"},
}


@contextlib.contextmanager
def profiler():
    """A CPU profiler whose first span starts a new session: a span opened
    without a profiler just before ends the last one."""
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def test_spans_and_counters_record_nothing_without_a_profiler():
    """Off the profiler a span is the null context and the session's
    sums stay as they were."""
    before = GLOBAL_TIMER.snapshot()
    assert not profiling.recording()
    with span("off/outer") as frame:
        assert frame is None
        with span("inner", device="cuda"):
            pass
    profiling.count("off/counter", 5)
    profiling.count_elapsed("off/gap", object(), object())
    assert GLOBAL_TIMER.snapshot() == before


def test_spans_record_names_counts_parents_and_self_time():
    with profiler():
        with span("outer", step=7):
            time.sleep(0.02)
            for _ in range(2):
                with span("inner"):
                    time.sleep(0.015)
        profiling.count("things", 3)
        profiling.count("things")
    snap = GLOBAL_TIMER.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["outer/inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert inner["host_s"] >= 0.03 and outer["host_s"] >= 0.05
    assert outer["self_host_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=2e-3)
    assert inner["self_host_s"] == inner["host_s"]
    # sleeping takes no CPU time, and off the card there is no device time
    assert outer["cpu_s"] < 0.5 * outer["host_s"]
    assert outer["device_s"] is None and inner["device_s"] is None
    assert snap["counters"]["things"] == {"total": 4, "calls": 2}
    records = GLOBAL_TIMER.records()
    assert [(r["name"], r["parent"]) for r in records] == [
        ("outer/inner", "outer"), ("outer/inner", "outer"), ("outer", None)]
    assert records[-1]["step"] == 7
    assert profiling.summed(snap, "inner")["count"] == 2
    assert profiling.summed(snap, "missing") is None


def test_main_thread_ranges_lie_in_the_profiler_window():
    with profiler() as prof:
        with record_function("window"):
            with span("layer"):
                with span("part"):
                    torch.ones(64).sum()
    events = {e.name: e.time_range for e in prof.events()}
    window = events["window"]
    for name in ("wsi/layer", "wsi/layer/part"):
        assert window.start <= events[name].start <= events[name].end <= window.end
    assert events["wsi/layer"].start <= events["wsi/layer/part"].start


@pytest.mark.parametrize("kind", ["span", "stage"])
def test_two_threads_nesting_keep_their_own_names(kind):
    """Two threads open their outer names, then both nest an inner one
    while the other's outer is still open."""
    timer = profiling.StageTimer()
    open_ = timer.span if kind == "span" else timer.stage
    barrier = threading.Barrier(2, timeout=10)

    def work(outer):
        with open_(outer):
            barrier.wait()
            with open_("inner"):
                barrier.wait()

    with profiler():
        threads = [threading.Thread(target=work, args=(f"t{i}",))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    names = (timer.snapshot()["spans"] if kind == "span" else timer.totals)
    assert sorted(names) == ["t0", "t0/inner", "t1", "t1/inner"]
    if kind == "stage":
        assert dict(timer.counts) == {n: 1 for n in names}


def test_a_thread_the_profiler_does_not_follow_is_mapped_by_the_anchor(
        tmp_path):
    """A thread started before the profiler: its span is in the snapshot
    and, on the trace's clock, inside the trace's `wsi/trace` range; the
    main thread's span lands on its own `record_function` range."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(10)
        with span("loader/read"):
            time.sleep(0.02)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with profiling.trace(str(tmp_path)):
        time.sleep(0.005)
        go.set()
        assert done.wait(10)
        with span("main"):
            time.sleep(0.01)
        time.sleep(0.005)
    t.join(timeout=10)
    assert GLOBAL_TIMER.snapshot()["spans"]["loader/read"]["count"] == 1
    trace_file = next(tmp_path.glob("*.pt.trace.json"))
    events = json.loads(trace_file.read_text())["traceEvents"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("name", "").startswith("wsi/")}
    assert "wsi/loader/read" not in ranges   # the profiler never saw it
    spans = json.loads(trace_file.with_name(
        trace_file.name + ".spans.json").read_text())
    got = {r["name"]: (r["start_us"], r["end_us"]) for r in spans["records"]}
    lo, hi = ranges["wsi/trace"]
    a, b = got["loader/read"]
    assert lo <= a < b <= hi and b - a >= 2e4
    main = ranges["wsi/main"]
    assert abs(got["main"][0] - main[0]) < 1e3
    assert abs(got["main"][1] - main[1]) < 1e3
    assert spans["spans"]["loader/read"]["card_idle_s"] is None  # no card


def test_export_counts_the_card_idle_inside_each_span(tmp_path):
    """card_idle_s is the part of a span's records that no kernel, copy
    or memset covers, on the clock the anchor maps."""
    with profiler():
        GLOBAL_TIMER.begin_session()
        with span("s"):
            time.sleep(0.02)
    rec = GLOBAL_TIMER.records()[0]
    a0 = 1e6   # where the anchor sits in the made-up trace (µs)
    off = a0 - GLOBAL_TIMER.anchor_ns * 1e-3
    start, end = rec["start_ns"] * 1e-3 + off, rec["end_ns"] * 1e-3 + off
    half = 0.5 * (end - start)
    events = [{"ph": "X", "name": "wsi/anchor", "ts": a0, "dur": 0},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": start - 5.0,
               "dur": 5.0 + half / 2},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c",
               "ts": start + half / 4, "dur": 3 * half / 4},
              {"ph": "X", "cat": "kernel", "name": "far", "ts": end + 10.0,
               "dur": 100.0}]
    path = tmp_path / "made.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = json.loads(open(GLOBAL_TIMER.export_spans(str(path))).read())
    (r,) = out["records"]
    assert r["start_us"] == pytest.approx(start) and r["end_us"] == pytest.approx(end)
    assert out["spans"]["s"]["card_idle_s"] == pytest.approx(half * 1e-6, rel=1e-6)


def test_a_second_session_replaces_the_first():
    with profiler():
        with span("first"):
            pass
    with span("between"):
        pass
    assert "first" in GLOBAL_TIMER.snapshot()["spans"]
    with profiler():
        with span("second"):
            pass
        profiling.count("c")
    snap = GLOBAL_TIMER.snapshot()
    assert sorted(snap["spans"]) == ["second"]
    assert snap["counters"] == {"c": {"total": 1, "calls": 1}}


def _cohort(root, n_slides=3):
    """KNN-lattice slides (radius 4) written as .npz, with list files."""
    rng = np.random.RandomState(0)
    paths, normals = [], []
    for i in range(n_slides):
        n = rng.randint(20, 40)
        feat = rng.randn(n, D).astype(np.float32) + (i % 2) * 1.5
        types = rng.randint(0, 6, n).astype(np.int32)
        g = build_lattice_device(torch.from_numpy(feat[None]),
                                 torch.from_numpy(types[None]),
                                 torch.ones(1, n, dtype=torch.bool), RADIUS, 6)
        k = g.idx.shape[2]
        barcode = f"TCGA-{i:02d}-0000-01Z-00-DX1"
        p = str(root / f"{barcode}.npz")
        save_graph_npz(p, feat, np.repeat(np.arange(n), k),
                       g.idx[0].reshape(-1).numpy(), node_type=types,
                       esign=g.esign[0].reshape(-1).numpy(),
                       sim=g.sim[0].reshape(-1).numpy())
        paths.append(p)
        if i % 2 == 0:
            normals.append(barcode[:16])
    (root / "train.txt").write_text("\n".join(paths) + "\n")
    (root / "normal.txt").write_text("\n".join(normals) + "\n")
    return root


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return _cohort(tmp_path_factory.mktemp("cohort"))


@pytest.mark.parametrize("kind", ["graph", "lattice"])
def test_loaders_record_read_pack_wait_and_to_device(cohort, kind):
    """One epoch of 3 slides in batches of 2: 3 reads, 2 packs, 2 copies,
    3 fetches (the two batches and the end), on the prefetch thread and
    the consumer's."""
    ds = GraphDataset(str(cohort / "train.txt"), str(cohort / "normal.txt"),
                      "BRCA", "train")
    if kind == "graph":
        loader = GraphLoader(ds, 2, seed=0)
    else:
        _, _, (k, cap) = probe_lattice_and_capacities(ds, 2)
        loader = LatticeLoader(ds, 2, k, cap, seed=0)
    with profiler():
        batches = list(loader)
    assert len(batches) == 2
    snap = GLOBAL_TIMER.snapshot()
    counts = {n: s["count"] for n, s in snap["spans"].items()}
    assert counts == {"loader/read": 3, "loader/pack": 2,
                      "loader/to_device": 2, "loader/wait": 3}
    assert all(s["device_s"] is None for s in snap["spans"].values())
    assert snap["spans"]["loader/read"]["cpu_s"] > 0
    starved = snap["counters"].get("loader/starved", {"total": 0})["total"]
    assert 0 <= starved <= 3
    threads = {r["name"]: r["thread"] for r in GLOBAL_TIMER.records()}
    assert threads["loader/read"] == threads["loader/pack"]
    assert threads["loader/wait"] == threads["loader/to_device"] \
        == threading.get_ident() != threads["loader/read"]


def _train_config(root, gnn):
    return {"name": "T", "train_type": "gnn", "eval_type": "homo-graph",
            "datasets": {"dataset": "BRCA", "task": "cancer classification",
                         "train_path": str(root / "train.txt"),
                         "eval_path": str(root / "train.txt"),
                         "valid_path": str(root / "train.txt"),
                         "normal_path": str(root / "normal.txt")},
            "checkpoint": {"path": str(root / f"ckpt_{gnn}")},
            "optimizer": {"opt_method": "ADAM", "lr": 0.001,
                          "weight_decay": 0.005},
            "GNN": dict(GNNS[gnn]),
            "train": {"num_epochs": 1, "batch_size": 2, "loss": "CE"}}


@pytest.mark.parametrize("gnn,lattice", [("heat4", True), ("hgt", False)])
def test_train_step_records_its_parts(cohort, gnn, lattice):
    """GNNTrainer.train_step on the lattice and the TypedGraph path: one
    `train/step` a step with its augment, forward, backward and optimizer
    parts; no device time on the CPU."""
    trainer = GNNTrainer(_train_config(cohort, gnn), seed=0, device="cpu")
    assert trainer.lattice == lattice
    with profiler():
        for g, labels, weights in trainer.loader:
            trainer.train_step(g, torch.from_numpy(labels).long(),
                               torch.from_numpy(weights))
    snap = GLOBAL_TIMER.snapshot()["spans"]
    parts = ("augment", "forward", "backward", "optimizer")
    assert {n: s["count"] for n, s in snap.items()
            if n.startswith("train/")} == {
        "train/step": 2, **{f"train/step/{p}": 2 for p in parts}}
    step = snap["train/step"]
    assert step["device_s"] is None
    assert step["self_host_s"] == pytest.approx(
        step["host_s"] - sum(snap[f"train/step/{p}"]["host_s"] for p in parts))


def test_predictor_records_chunks_and_predict_parts():
    """featurize with an injected encoder: one `featurize/chunk` a chunk
    (10 patches in chunks of 4), each holding the encoder's span; then
    predict_many's pack, lock wait, graph, model and download."""
    typed, _ = parse_gnn_model(dict(GNNS["heat4"]))
    convert.init_flax_like_(typed, 0)
    variables = {"params": convert.params_to_flax(
        typed, dict(typed.named_parameters()))}
    pred = SlidePredictor({"GNN": dict(GNNS["heat4"])}, radius=RADIUS,
                          variables=variables, device="cpu")
    rng = np.random.RandomState(0)

    def encoder(px):
        with span("encode/fake"):
            return (rng.randn(len(px), D).astype(np.float32),
                    rng.randint(0, 6, len(px)).astype(np.int32))

    pred.enable_pixels(encoder=encoder, patch_size=8, chunk=4)
    px = rng.randint(0, 256, (10, 8, 8, 3)).astype(np.uint8)
    with profiler():
        feats, types = pred.featurize(px)
        probs = pred.predict_many([(feats, types)])
    assert feats.shape == (10, D) and probs.shape == (1, 2)
    snap = GLOBAL_TIMER.snapshot()
    counts = {n: s["count"] for n, s in snap["spans"].items()}
    assert counts == {"featurize/chunk": 3, "featurize/chunk/encode/fake": 3,
                      **{f"predict/{p}": 1 for p in (
                          "pack", "lock_wait", "graph", "model", "download")}}
    assert [r["step"] for r in GLOBAL_TIMER.records()
            if r["name"] == "featurize/chunk"] == [0, 1, 2]
    assert snap["spans"]["predict/graph"]["device_s"] is None
    # the gap between chunks is card time: nothing to count off the card
    assert "featurize/chunk_gap_ns" not in snap["counters"]
    assert "pack_ms" not in pred.timing and "lock_wait_ms" not in pred.timing
