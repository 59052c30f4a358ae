"""Pixel-level explanation evaluation on Camelyon16 (counterpart of
wsi_hgnn_tpu/explain/explain_graphs.py, the reference's ExplainGraph).

Per tumour slide: the configured explainer gives a per-patch importance
mask; patch tile filenames (`{col}_{row}.jpeg`) map to level-k pixel
coordinates; each patch is labelled by point-in-polygon against the
annotation XML; the per-slide ROC-AUC of mask against labels is the
metric; a Wistia heatmap with the tumour outline is painted onto the
slide thumbnail.

The explainers run on the device of the run (the card unless `device`
says 'cpu'). Drawing uses PIL alone (the card machine has no cv2 or
matplotlib): filled patch rectangles as cv2.rectangle(..., FILLED) fills
them (both corners inclusive), open tumour polylines 4 px wide, colours
from a copy of matplotlib's Wistia colormap (its anchor table and its
256-entry lookup, under and over values clamped to the ends as
Normalize(0, 1) leaves them). openslide is optional, as in JAX (PIL
thumbnail for plain-image slides).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Tuple
from xml.dom import minidom

import numpy as np

from .. import convert
from ..config import parse_gnn_model
from ..data.datasets import C16EvalDataset
from ..graph.typed_graph import TypedGraph, to_homogeneous
from ..train.checkpoint import CheckpointManager
from ..train.metrics import binary_auc_from_scores
from ..utils import resolve_device, set_cuda_numerics

# matplotlib's Wistia (_cm._wistia_data): (x, y0, y1) anchors per channel
_WISTIA = {
    "red": ((0.0, 0.8941176470588236, 0.8941176470588236),
            (0.25, 1.0, 1.0), (0.5, 1.0, 1.0), (0.75, 1.0, 1.0),
            (1.0, 0.9882352941176471, 0.9882352941176471)),
    "green": ((0.0, 1.0, 1.0),
              (0.25, 0.9098039215686274, 0.9098039215686274),
              (0.5, 0.7411764705882353, 0.7411764705882353),
              (0.75, 0.6274509803921569, 0.6274509803921569),
              (1.0, 0.4980392156862745, 0.4980392156862745)),
    "blue": ((0.0, 0.47843137254901963, 0.47843137254901963),
             (0.25, 0.10196078431372549, 0.10196078431372549),
             (0.5, 0.0, 0.0), (0.75, 0.0, 0.0), (1.0, 0.0, 0.0)),
}
_LUT_N = 256


def _lookup_table(anchors, n: int = _LUT_N) -> np.ndarray:
    """matplotlib.colors._create_lookup_table at gamma 1."""
    a = np.asarray(anchors, float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], dist * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


WISTIA_LUT = np.stack([_lookup_table(_WISTIA[c])
                       for c in ("red", "green", "blue")], 1)   # [256, 3]


def wistia(values) -> np.ndarray:
    """RGB in [0, 1] per value, as matplotlib.colormaps['Wistia'](
    Normalize(0, 1)(values))[:, :3]: the value times 256 truncated to a
    table row, 1.0 the last row, below 0 the first, above 1 the last,
    NaN black."""
    v = np.asarray(values)
    xa = np.array(v, dtype=np.result_type(v.dtype, np.float32), copy=True)
    xa *= _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), -1, _LUT_N).astype(int)
    out = WISTIA_LUT[np.clip(idx, 0, _LUT_N - 1)]
    out[bad] = 0.0
    return out


def parse_annotation_xml(xml_path) -> List[np.ndarray]:
    """Tumour polygons from a Camelyon16 annotation XML: a list of [K, 2]
    float arrays."""
    polygons = minidom.parse(str(xml_path)).getElementsByTagName(
        "Coordinates")
    out = []
    for p in polygons:
        coords = [(float(c.attributes["X"].value),
                   float(c.attributes["Y"].value))
                  for c in p.childNodes if c.attributes]
        if coords:
            out.append(np.asarray(coords, np.float64))
    return out


def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorised even-odd ray cast: [P, 2] points vs a [K, 2] polygon ->
    bool [P] (shapely's Polygon.contains)."""
    x, y = points[:, 0:1], points[:, 1:2]
    x1, y1 = poly[:, 0][None, :], poly[:, 1][None, :]
    x2, y2 = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    crosses = ((y1 > y) != (y2 > y)) & (
        x < (x2 - x1) * (y - y1) / np.where(y2 - y1 == 0, 1e-30, y2 - y1) + x1)
    return crosses.sum(axis=1) % 2 == 1


def draw_heatmap(img: np.ndarray, node_mask, patches_coords, patch_size: int,
                 poly_coords, level: int) -> np.ndarray:
    """The overlay the reference paints with cv2: each patch a filled
    Wistia rectangle from (x, y) to (x + s, y + s) inclusive, then each
    tumour polygon (level-0 coordinates over 2**level, truncated) as an
    open red polyline 4 px wide. Returns a new RGB array."""
    from PIL import Image, ImageDraw

    out = Image.fromarray(np.ascontiguousarray(img))
    draw = ImageDraw.Draw(out)
    colours = np.rint(wistia(node_mask) * 255.0).astype(int)
    s = patch_size
    for (x, y), cl in zip(patches_coords, colours):
        draw.rectangle([x, y, x + s, y + s], fill=tuple(int(c) for c in cl))
    for coords in poly_coords:
        pts = (coords / 2 ** level).astype(np.int32)
        draw.line([tuple(int(v) for v in p) for p in pts], fill=(255, 0, 0),
                  width=4)
    return np.asarray(out)


class ExplainGraph:
    def __init__(self, config: Dict, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        self.config = config
        self.config_data = config["datasets"]
        self.config_gnn = config["GNN"]
        self.config_eval = config["eval"]
        self.name = self.config_data["dataset"]
        self.patches_path = self.config_data["patches_path"]
        self.wsi_path = self.config_data["wsi_path"]
        self.explain_path = self.config_eval["explain_path"]
        self.annot_path = self.config_eval["annotation_path"]
        Path(self.explain_path).mkdir(parents=True, exist_ok=True)

        self.eval_data = C16EvalDataset(
            self.config_data["eval_path"], self.annot_path,
            self.config_data.get(
                "reference_csv", "./data/camelyon16/testing/reference.csv"))

        self.checkpoint_manager = CheckpointManager(config["checkpoint"]["path"])
        self.model, self.is_hetero = parse_gnn_model(self.config_gnn)
        # a missing checkpoint raises: explaining random weights would
        # print plausible-looking AUCs
        self.variables = self.checkpoint_manager.restore_variables()
        convert.load_flax_variables(self.model, self.variables)
        self.model.to(self.device).eval()

        self.n_hops = self.config_gnn["num_layers"] - 1
        self.level = self.config_eval["level"]
        self.base_patch_size = self.config_eval["patch_size"]
        self.patch_size = self.config_eval["patch_size"] // (
            2 ** (self.level - 1))
        self.explainer_name = self.config_eval["explainer_name"]
        self.last_scores: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------ #
    def _model_fn(self, g: TypedGraph, feat_override=None):
        if feat_override is not None:
            g = g.replace(feat=feat_override)
        return self.model(g if self.is_hetero else to_homogeneous(g))

    def get_magnified_image(self, name: str):
        """Slide thumbnail at the configured level: openslide for
        .svs/.tif pyramids, PIL otherwise."""
        suffix = ".svs" if self.name == "COAD" else ".tif"
        path = self.wsi_path + name + suffix
        try:
            from openslide import OpenSlide

            wsi = OpenSlide(path)
            dim = wsi.level_dimensions[self.level]
            return (np.asarray(wsi.get_thumbnail(dim).convert("RGB")),
                    wsi.dimensions)
        except Exception:
            # openslide absent, or the slide is no openslide pyramid
            from PIL import Image

            for ext in (suffix, ".png", ".jpeg", ".jpg"):
                p = self.wsi_path + name + ext
                if os.path.exists(p):
                    img = Image.open(p).convert("RGB")
                    w, h = img.size
                    f = 2 ** self.level
                    return np.asarray(img.resize((w // f, h // f))), (w, h)
            raise FileNotFoundError(path)

    def get_patch_coords(self, name: str) -> List[Tuple[int, int]]:
        """Tile filename (col_row) -> level-`level` pixel coords, listed as
        the graph constructor lists patches (sorted files only), so they
        keep the graph's node order."""
        from ..pipeline.patches import list_patches

        mag_factor = 2 ** (self.level - 1)
        out = []
        for p in list_patches(Path(self.patches_path) / name):
            x, y = p.name.rsplit(".", 1)[0].split("_")[:2]
            out.append((self.base_patch_size * int(x) // mag_factor,
                        self.base_patch_size * int(y) // mag_factor))
        return out

    def get_ground_truths(self, xml_path, patches_coords):
        """Point-in-polygon patch labels: patch centre at level 0 =
        coord * 2**level + base_patch_size."""
        polygons = parse_annotation_xml(xml_path)
        mag_factor = 2 ** self.level
        s = self.base_patch_size * 2 // 2
        centers = np.asarray(
            [(cx * mag_factor + s, cy * mag_factor + s)
             for cx, cy in patches_coords], np.float64).reshape(-1, 2)
        labels = np.zeros(len(centers), np.int32)
        for poly in polygons:
            labels |= points_in_polygon(centers, poly).astype(np.int32)
        return labels.tolist(), polygons

    def visualize(self, node_mask, wsi_name, patches_coords, poly_coords, img):
        """The thumbnail as `<name>.png`, the overlay as `<name>.jpeg`."""
        from PIL import Image

        Image.fromarray(np.asarray(img)).save(
            os.path.join(self.explain_path, wsi_name + ".png"))
        out = draw_heatmap(img, node_mask, patches_coords, self.patch_size,
                           poly_coords, self.level)
        Image.fromarray(out).save(
            os.path.join(self.explain_path, wsi_name + ".jpeg"))

    # ------------------------------------------------------------------ #
    def explain_one(self, graph: TypedGraph, label: int) -> np.ndarray:
        from .gem import GemExplainer, HetGemExplainer
        from .gnn_explainer import GNNExplainer

        if self.explainer_name == "GNNExplainer":
            _, node_mask = GNNExplainer(graph, self._model_fn,
                                        num_hops=self.n_hops,
                                        model=self.model).explain_node(None)
            return node_mask
        if self.explainer_name == "GemExplainer":
            if graph.is_homogeneous:
                return GemExplainer(graph, self._model_fn, label).explain_node()
            return HetGemExplainer(graph, self._model_fn, label).flat_scores()
        raise NotImplementedError("This Explainer is not implemented")

    def eval(self) -> List[float]:
        auc_list = []
        for idx in range(len(self.eval_data)):
            path = self.eval_data.graph_paths[idx]
            graph, xml_path, label = self.eval_data[idx]
            wsi_name = Path(path).parts[-1][:-4]

            node_mask = self.explain_one(graph.to_torch(self.device), label)
            self.last_scores[wsi_name] = np.asarray(node_mask)

            img, _ = self.get_magnified_image(wsi_name)
            patches_coords = self.get_patch_coords(wsi_name)
            labels, poly_coords = self.get_ground_truths(xml_path,
                                                         patches_coords)

            auc = binary_auc_from_scores(np.asarray(labels),
                                         np.asarray(node_mask))
            auc_list.append(auc)
            self.visualize(node_mask, wsi_name, patches_coords, poly_coords,
                           img)
            print(f"Mean AUCROC: {np.nanmean(auc_list)}")
        return auc_list
