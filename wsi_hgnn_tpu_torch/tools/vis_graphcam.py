"""GraphCAM of a trained GTNMIL GraphTransformer with the port
(counterpart of tools/vis_graphcam.py):

  python -m wsi_hgnn_tpu_torch.tools.vis_graphcam --bag bag.npz \\
      --params runs/gtn_fold0.pkl --out cam_vis [--device cpu]

Reads a bag (.npz with `feat` [N, D] and optional `xy` [N, 2] tile
coordinates, or a bare .npy; a square raster grid stands in for missing
coordinates) and a gtn fold pickle written by either package's
`train_mil --model gtn --save-dir`. Per class, the transformer-LRP
GraphCAM of every tile (models.mil.graph_transformer.graphcam), min-max
normalised, scaled by the class probability and clipped to [0, 1].
Writes `<out>.npz` (`cam` [C, N], `probs` [C], `xy` [N, 2]) and
`<out>.png`, one Wistia tile raster per class drawn with PIL. Runs on the
card unless --device cpu.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from .. import convert
from ..models.mil import GraphTransformer, graphcam, pad_bag, spatial_adjacency
from ..utils import resolve_device, set_cuda_numerics

PNG_TILE = 4        # pixels per tile in the PNG
PNG_MIN_SIDE = 128  # the smaller raster side is scaled up to at least this


def load_bag(path: str):
    """(feats [N, D] f32, xy [N, 2] int64) of a bag file."""
    from ..train_mil import grid_coords

    xy = None
    if path.endswith(".npz"):
        with np.load(path) as z:
            feats = np.asarray(z["feat"], np.float32)
            if "xy" in z:
                xy = np.asarray(z["xy"], np.int64)
    else:
        feats = np.asarray(np.load(path), np.float32)
    return feats, (grid_coords(len(feats)) if xy is None else xy)


def load_gtn(path: str, device: torch.device):
    """(GraphTransformer in eval mode on `device`, meta) of a gtn fold
    pickle."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    meta = ckpt["meta"]
    if meta.get("model") != "gtn":
        raise SystemExit(f"--params is a {meta.get('model')} checkpoint, "
                         "GraphCAM needs a gtn one")
    model = GraphTransformer(int(meta["num_classes"]), int(meta["in_dim"]),
                             int(meta["hidden"]), int(meta["clusters"]))
    convert.load_flax_variables(model, ckpt["params"])
    return model.to(device).eval(), meta


def bag_inputs(feats, xy, cap: int, device: torch.device):
    """(node_feat [1, cap, D], dense adjacency [1, cap, cap], mask [1, cap])
    of one bag over its 8-neighbour tile graph."""
    f, m = pad_bag(feats, capacity=cap)
    src, dst = spatial_adjacency([tuple(c) for c in xy])
    adj = np.zeros((cap, cap), np.float32)
    adj[src, dst] = 1.0
    f_t, adj_t, m_t = (torch.from_numpy(a[None]).to(device)
                       for a in (f, adj, m))
    return f_t, adj_t, m_t


def raw_cams(model, f, a, m, n: int) -> torch.Tensor:
    """[C, n] GraphCAM of every class, before normalisation."""
    return torch.stack([graphcam(model, f, a, m, c)[:n]
                        for c in range(model.head.out_features)])


def normalise(cams: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Per class: min-max normalise, scale by p_c, clip to [0, 1]."""
    out = []
    for cam, p in zip(cams, probs):
        lo, hi = cam.min(), cam.max()
        cam = (cam - lo) / (hi - lo) if hi > lo else np.zeros_like(cam)
        out.append(np.clip(p * cam, 0.0, 1.0))
    return np.stack(out)


def write_png(path: str, cams: np.ndarray, probs: np.ndarray,
              xy: np.ndarray) -> None:
    """One Wistia raster per class (tile (x, y) at column x, row y;
    empty cells at 0), side by side, each titled with its probability."""
    from PIL import Image, ImageDraw

    from ..explain.explain_graphs import wistia

    w, h = int(xy[:, 0].max()) + 1, int(xy[:, 1].max()) + 1
    scale = max(PNG_TILE, -(-PNG_MIN_SIDE // min(w, h)))
    title, gap = 14, 8
    sheet = Image.new("RGB", (len(cams) * (w * scale + gap) + gap,
                              h * scale + title + gap), "white")
    draw = ImageDraw.Draw(sheet)
    for c, cam in enumerate(cams):
        grid = np.zeros((h, w))
        grid[xy[:, 1], xy[:, 0]] = cam
        rgb = (wistia(grid) * 255.0 + 0.5).astype(np.uint8)
        tile = Image.fromarray(rgb).resize((w * scale, h * scale),
                                           Image.Resampling.NEAREST)
        x0 = gap + c * (w * scale + gap)
        sheet.paste(tile, (x0, title))
        draw.text((x0, 1), f"class {c} (p={probs[c]:.3f})", fill="black")
    sheet.save(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bag", required=True, help=".npz (feat[, xy]) or .npy")
    ap.add_argument("--params", required=True,
                    help="gtn fold pickle from train_mil --save-dir")
    ap.add_argument("--out", default="graphcam_vis")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_cuda_numerics()

    model, meta = load_gtn(args.params, dev)
    feats, xy = load_bag(args.bag)
    n = len(feats)
    f, a, m = bag_inputs(feats, xy, int(meta["cap"]), dev)
    with torch.no_grad():
        probs = torch.softmax(model(f, a, m)[0], -1)[0].cpu().numpy()
    cams = normalise(raw_cams(model, f, a, m, n).cpu().numpy(), probs)
    np.savez(args.out + ".npz", cam=cams, probs=probs, xy=xy)
    print(f"probs: {np.round(probs, 4).tolist()}; wrote {args.out}.npz")
    write_png(args.out + ".png", cams, probs, xy)
    print(f"wrote {args.out}.png")
    return cams, probs


if __name__ == "__main__":
    main()
