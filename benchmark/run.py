"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`: its configuration
(`benchmark/configs/<config>.json`), its traffic kind (the driver
`benchmark/traffic/<kind>.py`), the traffic's parameters and the limits
of the numbers compared for `correct`. With --trace 0 the result carries
the cell's end-to-end metrics of BENCHMARK.json, with --trace 1 its
per-layer metrics, each read by `benchmark/metrics/<metric>.py` from the
run's record (a reader that finds nothing to read leaves its metric out).

Set-up (weights and inputs made from the seed, every shape warmed up)
comes first and is `setup_s`; the window then runs for --seconds; the
outputs it produced are checked against the plain reference in
`benchmark/reference/` once it has closed. Needs a CUDA card (as many as
the cell asks for); without one it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(cell: str):
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    return workload, config


def load_driver(kind: str):
    path = HERE / "traffic" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_traffic_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scratch_dir(cell: str) -> Path:
    """Files a run writes: under TMPDIR at a path fixed by the cell."""
    base = Path(os.environ.get("TMPDIR") or "/tmp")
    return base / "wsi_hgnn_benchmark" / cell


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             workload=None, config=None, control: bool = False,
             t_start: float = None):
    """The cell's Outcome (common.Outcome). `workload` and `config`
    default to the cell's files; tests pass smaller ones."""
    from common import Ctx

    if workload is None or config is None:
        w, c = load_cell(cell)
        workload = workload or w
        config = config or c
    ctx = Ctx(cell=cell, workload=workload, config=config, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=device,
              t_start=T_START if t_start is None else t_start,
              control=control, scratch=scratch_dir(cell))
    return load_driver(workload["traffic"]).run(ctx)


def result_line(cell: str, outcome, trace: bool, device_kind: str,
                bench: dict) -> dict:
    from common import cell_metrics, is_correct, load_reader

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            value = load_reader(m["name"])(outcome.record)
        else:
            value = outcome.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": 1,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": is_correct(outcome.checks),
              "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": device}
    tr = outcome.record.get("trace")
    if trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in tr["top_ops"]],
                               "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from common import emit, forbidden_loaded

    workload, config = load_cell(args.workload)
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    outcome = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda"),
                       workload, config)
    result = result_line(args.workload, outcome, bool(args.trace),
                         torch.cuda.get_device_name(0), bench)
    loaded = forbidden_loaded()
    if loaded:
        print("JAX or the JAX package was loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    emit(result, outcome.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
