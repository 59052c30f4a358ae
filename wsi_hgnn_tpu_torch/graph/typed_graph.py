"""Size-bucketing policy (counterpart of
wsi_hgnn_tpu/graph/typed_graph.py::bucket_size; the port keeps its own
copy so it imports nothing of the JAX package)."""
from __future__ import annotations


def bucket_size(n: int, *, base: int = 256) -> int:
    """Next capacity >= n from {base, 1.5*base, 2*base, 3*base, 4*base, ...}:
    two points per octave cap padding waste at ~33%."""
    n = max(int(n), 1)
    cap = base
    while cap < n:
        if cap + cap // 2 >= n:
            return cap + cap // 2
        cap *= 2
    return cap
