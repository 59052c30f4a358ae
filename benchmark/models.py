"""What the drivers build from a configuration file: seeded weights (the
same tree for the program and the reference), the program's predictor,
and the structured patch pool."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from common import sub_seed
from reference import weights as W


def gnn_spec(config: Dict):
    gnn = config["GNN"]
    name = str(gnn["name"]).upper()
    if name == "HEAT4":
        return W.heat4_spec(gnn)
    if name == "HGT":
        return W.hgt_spec(gnn)
    raise ValueError(f"no weight spec for {gnn['name']!r}")


def gnn_weights(config: Dict, seed: int, device) -> Dict:
    return W.make_weights(gnn_spec(config), sub_seed(seed, "gnn"), device)


def cnn_weights(config: Dict, seed: int, device, calib: np.ndarray
                ) -> Tuple[Dict, Dict]:
    """KimiaNet's and HoVer-Net's seeded weights, calibrated on the uint8
    patches `calib` (reference/cnn.py::calibrate)."""
    import torch

    from reference.cnn import calibrate

    pixels = config["pixels"]
    kimia = W.make_weights(W.kimianet_spec(), sub_seed(seed, "kimianet"), device)
    hover = W.make_weights(
        W.hovernet_typing_spec(int(pixels["n_node_types"]),
                               3 if pixels["hovernet_mode"] == "fast" else 5),
        sub_seed(seed, "hovernet"), device)
    calibrate(kimia, hover, torch.from_numpy(np.ascontiguousarray(calib)).to(device))
    return kimia, hover


def predictor(config: Dict, gnn_w: Dict, device):
    """The program's SlidePredictor on the seeded GNN weights."""
    from wsi_hgnn_tpu_torch.serve import SlidePredictor

    graph = config["graph"]
    return SlidePredictor({"GNN": dict(config["GNN"])},
                          radius=int(graph["radius"]),
                          n_node_types=int(graph["n_node_types"]),
                          knn_impl=graph["knn_impl"],
                          variables=W.to_numpy(gnn_w), device=device)


def enable_pixels(pred, config: Dict, kimia_w: Dict, hover_w: Dict) -> None:
    pixels = config["pixels"]
    pred.enable_pixels(
        hovernet_config={"batch_size": int(pixels["chunk"]),
                         "mode": pixels["hovernet_mode"]},
        kimia_variables=W.to_numpy(kimia_w),
        hover_variables=W.to_numpy(hover_w),
        patch_size=int(pixels["patch_size"]))


def patch_pool(n: int, size: int, seed: int, device, batch: int = 256
               ) -> np.ndarray:
    """n uint8 RGB patches [n, size, size, 3], made on the device: a
    colour per patch, smooth structure at two scales and pixel noise, so
    that patches differ as tissue tiles do and their features are far
    from one another."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    kw = dict(generator=gen, device=device)
    for i in range(0, n, batch):
        b = min(batch, n - i)
        base = torch.rand((b, 3, 1, 1), **kw) * 160.0 + 48.0
        coarse = F.interpolate(torch.randn((b, 3, 8, 8), **kw), size=size,
                               mode="bilinear", align_corners=False) * 40.0
        mid = F.interpolate(torch.randn((b, 1, 32, 32), **kw), size=size,
                            mode="bilinear", align_corners=False) * 25.0
        fine = torch.randn((b, 3, size, size), **kw) * 12.0
        x = (base + coarse + mid + fine).clamp(0, 255).round()
        out[i:i + b] = x.to(torch.uint8).permute(0, 2, 3, 1)
    host = out.cpu().numpy()
    del out
    return host
