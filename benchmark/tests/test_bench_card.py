"""On the card, at each cell's own size: the program's outputs pass the
cell's limits and its control (the reference one precision below, or a
planted fault) fails them. Run on a machine with a card:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m gpu benchmark/tests/test_bench_card.py

(`--noconftest` keeps the repository's tests/conftest.py, which loads
JAX, out; this file finds the benchmark's modules itself.)"""
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH.parent, BENCH / "loadgen"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["heat4-serve-pixels", "hgt-train", "heat4-train"])
def test_program_passes_and_control_fails(cell, card):
    import run as bench_run

    out = bench_run.run_cell(cell, 987654321987, 3.0, False, card,
                             control=True, t_start=time.perf_counter())
    assert all(v <= lim for v, lim in out.checks.values()), out.checks
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    assert any(v > limits[k.split(".")[-1]]
               for k, v in out.control_checks.items()), out.control_checks
