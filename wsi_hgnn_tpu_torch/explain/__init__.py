"""Post-hoc explanation: GNNExplainer, GEM, Camelyon16 pixel-level eval
(counterpart of wsi_hgnn_tpu/explain)."""
from .explain_graphs import ExplainGraph, parse_annotation_xml, points_in_polygon
from .gem import GemExplainer, HetGemExplainer
from .gnn_explainer import GNNExplainer

__all__ = [
    "GemExplainer",
    "HetGemExplainer",
    "GNNExplainer",
    "ExplainGraph",
    "parse_annotation_xml",
    "points_in_polygon",
]
