"""The request bodies of feature traffic: `.npz` with `features` [N, D]
f32 and `node_types` [N] int32, as the server's wire format takes them.
Body i of a pool depends on the seed and i alone, so the load generator
and the checker make the same body independently. numpy only."""
from __future__ import annotations

import io
from typing import List

import numpy as np


CLUSTER = 9          # a node and its radius - 1 = 8 neighbours
CENTRE_SCALE = 0.5 ** 0.5


def body_sizes(lo: int, hi: int, count: int) -> List[int]:
    """`count` slide sizes, log-spaced from lo to hi, each rounded down to
    a whole number of CLUSTER-node clusters."""
    if count == 1:
        return [int(hi) // CLUSTER * CLUSTER]
    return [int(round(x)) // CLUSTER * CLUSTER
            for x in np.exp(np.linspace(np.log(lo), np.log(hi), count))]


def body_arrays(seed: int, i: int, n: int, dim: int, n_types: int):
    """(features [n, dim] f32, node types [n] int32) of body i: clusters
    of CLUSTER rows around seeded centres, in a seeded order. A row's 8
    nearest neighbours are its cluster-mates, with distances about 2/3
    of the nearest outsider's (unit noise against centres of variance
    1/2 per feature): no two candidates are near a tie, so every exact
    KNN in f32 builds the same graph, while TF32 products do not."""
    rng = np.random.default_rng([int(seed), int(i)])
    centres = CENTRE_SCALE * rng.standard_normal((n // CLUSTER, dim),
                                                 dtype=np.float32)
    feats = (np.repeat(centres, CLUSTER, axis=0)
             + rng.standard_normal((n, dim), dtype=np.float32))
    feats = feats[rng.permutation(n)]
    types = rng.integers(0, n_types, n).astype(np.int32)
    return np.ascontiguousarray(feats, np.float32), types


def encode(features: np.ndarray, node_types: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, features=features, node_types=node_types)
    return buf.getvalue()
