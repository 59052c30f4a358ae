"""The tile-grid helpers of the SimCLR module that GTN needs (counterpart
of wsi_hgnn_tpu/models/mil/simclr.py::spatial_adjacency and
coords_from_patch_names)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def spatial_adjacency(coords: Sequence[Tuple[int, int]]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) 8-neighbour spatial edges from `{col}_{row}` tile
    coordinates: tiles adjacent on the grid (diagonals included) are
    connected, both directions."""
    index = {tuple(c): i for i, c in enumerate(coords)}
    src, dst = [], []
    for i, (x, y) in enumerate(coords):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                j = index.get((x + dx, y + dy))
                if j is not None:
                    src.append(i)
                    dst.append(j)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def coords_from_patch_names(names: Sequence[str]) -> List[Tuple[int, int]]:
    """`{col}_{row}.jpeg` tile filenames -> (col, row) ints."""
    out = []
    for n in names:
        x, y = n.rsplit(".", 1)[0].split("_")[:2]
        out.append((int(x), int(y)))
    return out
