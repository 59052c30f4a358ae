"""Padded-bag representation of the MIL baselines (counterpart of
wsi_hgnn_tpu/models/mil/bags.py): a bag is (feats [N_max, D] f32, mask
[N_max] bool) on the host, one capacity per cohort."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...graph.typed_graph import bucket_size


def pad_bag(feats: np.ndarray, capacity: Optional[int] = None,
            bucket_base: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    n, d = feats.shape
    cap = capacity or bucket_size(n, base=bucket_base)
    out = np.zeros((cap, d), np.float32)
    out[:n] = feats
    mask = np.arange(cap) < n
    return out, mask
