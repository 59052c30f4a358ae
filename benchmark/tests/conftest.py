"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository's root. They import the benchmark's modules by path and the
port's package from the root; none imports JAX."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH.parent, BENCH / "loadgen"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# feature requests over HTTP (traffic/features_open.py): no cell of
# BENCHMARK.json runs them yet (PERF.md, Open questions); the tests drive
# the driver with this workload
FEATURES = {
    "name": "heat4-serve-features", "config": "brca-heat4-kimia",
    "traffic": "features_open", "chips": 1,
    "why": "feature bodies over HTTP under an open loop",
    "params": {"rate_per_s": 5.0, "bodies": 4, "min_nodes": 27,
               "max_nodes": 45, "max_batch": 8, "max_wait_ms": 5.0,
               "pad_batches": True, "warm_buckets": [256],
               "concurrency": 64, "tail_s": 10.0, "trace_s": 0.5},
    "limits": {"prob_gap": 2e-6},
}


def load_cell(cell):
    import copy
    import json

    import run as bench_run

    if cell == FEATURES["name"]:
        with open(BENCH / "configs" / f"{FEATURES['config']}.json") as f:
            return copy.deepcopy(FEATURES), json.load(f)
    return bench_run.load_cell(cell)


def tiny(cell):
    """The cell's workload and configuration cut to what a CPU test holds
    (the widths of the CNNs stay: their weights are fixed by the
    architecture; GNN widths, slide sizes and pools shrink)."""
    import copy

    w, c = load_cell(cell)
    w, c = copy.deepcopy(w), copy.deepcopy(c)
    c["GNN"]["hidden_dim"] = 16
    for key in ("n_heads", "num_heads"):
        if key in c["GNN"]:
            c["GNN"][key] = 2
    p = w["params"]
    if w["traffic"] == "pixels_closed":
        c["pixels"]["chunk"] = 4
        p.update(pool_patches=16, min_patches=10, max_patches=12, sizes=2,
                 warm_buckets=[256], sample_patches=3, calib_patches=4)
    elif w["traffic"] == "train_epochs":
        c["GNN"]["in_dim"] = 32
        p.update(slides=4, min_nodes=20, max_nodes=40)
    else:
        c["GNN"]["in_dim"] = 32
    return w, c


def run_tiny(cell, seed=7, seconds=1.0, control=False):
    import time

    import torch

    import run as bench_run

    w, c = tiny(cell)
    return bench_run.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                              w, c, control=control, t_start=time.perf_counter())
