"""Find the feature server's knee: the highest offered rate it sustains
without a growing backlog.

    python3 benchmark/sweep.py --workload <features_open cell> --rates 10,20,40 --seconds 10 --seed 5

Runs the cell at each rate in one process (the workload file's rate
replaced) and prints one JSON line a rate: requests due and failed,
completed per second, latency p50 and p95 from the due time, the p50 of
the window's first and last thirds (a backlog that grows shows as the
last third's rising over the first's), and how late the generator sent.
A cell's rate is chosen from the knee found here (PERF.md). Needs a
CUDA card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    workload, config = bench_run.load_cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        w = copy.deepcopy(workload)
        w["params"]["rate_per_s"] = rate
        t0 = time.perf_counter()
        out = bench_run.run_cell(args.workload, args.seed, args.seconds, False,
                                 torch.device("cuda"), w, config, t_start=t0)
        rec = out.record
        pairs = sorted((d, l) for d, l in rec["latency_by_due"] if d is not None)
        lat = np.array([l for _, l in pairs])
        third = max(1, len(lat) // 3)
        c = rec["counters"]
        print(json.dumps({
            "rate": rate, "due": out.attempted, "failed": out.failed,
            "completed_per_s": (out.attempted - out.failed) / args.seconds,
            "p50_ms": float(np.median(lat)),
            "p95_ms": out.end_to_end["ft_latency_p95_ms"],
            "p50_first_third_ms": float(np.median(lat[:third])),
            "p50_last_third_ms": float(np.median(lat[-third:])),
            "late_p99_ms": float(np.quantile(rec["lateness_s"], 0.99)) * 1e3,
            "group_size": c["requests"] / max(1, c["batches"]),
            "decode_ms": c["decode_ms_sum"] / max(1, c["requests"]),
            "correct": all(v <= lim for v, lim in out.checks.values())}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
