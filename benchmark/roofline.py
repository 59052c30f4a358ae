"""Frozen arithmetic: the card's peaks, and the operations and bytes each
piece of work needs, from its shapes alone.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit. A card set below 700 W reaches less; results carry the card's
power limit beside every share.

A kernel's bound is the larger of bytes / HBM rate and operations / the
peak of the type it computes in; its roofline share is that bound over
the measured kernel time. The whole step's MFU is the time the work
would take at the peaks (each part at its own type's peak) over the time
it took.
"""
from __future__ import annotations

from typing import Dict, Iterable

PEAK_BYTES = 3.35e12                      # HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}

# KimiaNet's DenseNet-121 dense blocks at a 256 x 256 patch:
# (spatial side H, channels entering the block, dense layers)
DENSE_BLOCKS = ((64, 64, 6), (32, 128, 12), (16, 256, 24), (8, 512, 16))
# its three transitions: (H, channels in), output H/2 and channels/2
TRANSITIONS = ((64, 256), (32, 512), (16, 1024))

# Operations a patch needs, counted by torch.utils.flop_counter on the
# reference (reference/cnn.py) at one 256 x 256 patch; the benchmark's
# tests count them again.
KIMIANET_FLOPS_PER_PATCH = 7_400_849_408
HOVERNET_TYPING_FLOPS_PER_PATCH = 213_579_034_624


def bound_s(bytes_moved: float, flops: float, dtype: str) -> float:
    """Least seconds the card can take: bytes or operations, whichever
    bounds."""
    return max(bytes_moved / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def knn_ops(n: int, d: int) -> int:
    """Exact KNN of n rows of width d: the n x n distances' d-long dot
    products and the norms, n * (n + 1) * d."""
    return n * (n + 1) * d


def dense_layer_bytes_flops(chunk: int, h: int, k_in: int):
    """One bf16 DenseNet dense layer over `chunk` patches at side h with
    k_in input channels: it reads the k_in-channel prefix and writes its
    32 new channels (2 bytes each), reads W1 [k_in, 128] and W2 [128, 288]
    once; 1x1 conv to 128 then 3x3 conv to 32."""
    px = chunk * h * h
    bytes_moved = px * (k_in + 32) * 2 + (k_in * 128 + 128 * 288) * 2
    flops = 2.0 * px * (k_in * 128 + 9 * 128 * 32)
    return bytes_moved, flops


def dense_layer_chunk_bound_s(chunk: int) -> float:
    """Summed bound of one chunk's 58 dense layers."""
    total = 0.0
    for h, ch, n_layers in DENSE_BLOCKS:
        for li in range(n_layers):
            total += bound_s(*dense_layer_bytes_flops(chunk, h, ch + 32 * li),
                             "bfloat16")
    return total


def transition_bytes_flops(chunk: int, h: int, c: int):
    """One bf16 transition: BN affine + ReLU, 1x1 conv c -> c/2, 2x2 mean
    pool; reads x and W once, writes the pooled output."""
    m = chunk * (h // 2) * (h // 2)
    bytes_moved = chunk * h * h * c * 2 + c * (c // 2) * 2 + m * (c // 2) * 2 + 8 * c
    flops = 2.0 * m * c * (c // 2) + 4.0 * m * 4 * c
    return bytes_moved, flops


def transition_chunk_bound_s(chunk: int) -> float:
    return sum(bound_s(*transition_bytes_flops(chunk, h, c), "bfloat16")
               for h, c in TRANSITIONS)


# ---------------------------------------------------------------------------
# whole models (forward operations)
# ---------------------------------------------------------------------------
def cnn_flops_per_patch() -> int:
    return KIMIANET_FLOPS_PER_PATCH + HOVERNET_TYPING_FLOPS_PER_PATCH


def heat4_forward_flops(n: int, e: int, gnn: Dict) -> float:
    """HEAT4 on n nodes and e live edges: the typed maps (input, then K, Q,
    V and the output map per layer), the edge scores and the messages."""
    d_in, hid = int(gnn["in_dim"]), int(gnn["hidden_dim"])
    layers = int(gnn["num_layers"])
    typed = 2.0 * n * d_in * hid + layers * 4 * 2.0 * n * hid * hid
    edges = layers * 2 * 2.0 * e * hid
    return typed + edges


def hgt_forward_flops(n: int, e: int, gnn: Dict) -> float:
    """HGT on n nodes and e live edges: the typed maps, each node's K and
    V under its 2 T (sign, destination type) relation transforms, the
    scores and the messages."""
    d_in, hid = int(gnn["in_dim"]), int(gnn["hidden_dim"])
    heads, t = int(gnn["num_heads"]), int(gnn["n_node_types"])
    dk = hid // heads
    layers = int(gnn["num_layers"])
    typed = 2.0 * n * d_in * hid + layers * 4 * 2.0 * n * hid * hid
    relation = layers * 2 * (2 * t) * heads * 2.0 * n * dk * dk
    edges = layers * 2 * 2.0 * e * hid
    return typed + relation + edges


def gnn_forward_flops(model: str, n: int, e: int, gnn: Dict) -> float:
    if model == "heat4":
        return heat4_forward_flops(n, e, gnn)
    if model == "hgt":
        return hgt_forward_flops(n, e, gnn)
    raise ValueError(f"no operation count for {model!r}")


def train_flops(model: str, sizes: Iterable, gnn: Dict) -> float:
    """Forward and backward (three forwards' operations) over real
    (nodes, edges) of the slides stepped."""
    return sum(3.0 * gnn_forward_flops(model, n, e, gnn) for n, e in sizes)


def seconds_at_peak(flops_by_dtype: Dict[str, float]) -> float:
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items())
