"""Readings that the correctness limits are set from (PERF.md, section 2).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control 1]

Runs the cell once per seed in one process, each run as `run.py` runs
it (short windows do: the readings are of the outputs, not the times),
and prints one JSON line per seed: the numbers compared, and with
--control 1 the same numbers read off the controls (the reference in the
precision below the configuration's, and the planted faults a cell can
have) in the program's place. Needs a CUDA card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from common import forbidden_loaded

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = bench_run.run_cell(args.workload, seed, args.seconds, False,
                                 torch.device("cuda"), control=bool(args.control),
                                 t_start=t0)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "checks": {k: v for k, (v, _) in out.checks.items()},
            "control": out.control_checks,
            "diag": out.record.get("diag"),
            "end_to_end": out.end_to_end, "attempted": out.attempted,
            "failed": out.failed, "seconds": time.perf_counter() - t0}),
            flush=True)
    loaded = forbidden_loaded()
    if loaded:
        print("JAX or the JAX package was loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
