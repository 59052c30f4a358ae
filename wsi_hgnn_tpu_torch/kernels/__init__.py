"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. A wrapper runs the plain version for CPU tensors only; for a CUDA
tensor it launches its kernel or raises. Each wrapper counts its kernel
launches in a plain integer attribute, `<wrapper>.launches`."""
from __future__ import annotations

from typing import Dict

from .densenet import dense_layer_fused, transition_fused
from .knn import knn_l2_fused

WRAPPERS = (knn_l2_fused, dense_layer_fused, transition_fused)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
