"""Size torch's intra-op thread pool to one test worker's share of the
host's cores.

Under pytest-xdist every worker process would otherwise start one thread
per core, so n workers run n times as many threads as there are cores
and torch's spinning threads crowd out each other and JAX: the port's
heaviest test files took 2.4 times as long in 6 workers on 8 cores as
with one thread each. Alone (no xdist) the pool is left as torch sets it.
Every tests/test_torch_*.py imports this module.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
