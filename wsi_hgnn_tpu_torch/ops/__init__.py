"""Graph-construction ops: exact KNN and Pearson edge typing."""
from .knn import STREAM_THRESHOLD, knn_l2, knn_l2_tiled, knn_lookup
from .pearson import center_normalize, pearson_edges, pearson_sim_at

__all__ = ["STREAM_THRESHOLD", "knn_l2", "knn_l2_tiled", "knn_lookup",
           "center_normalize", "pearson_edges", "pearson_sim_at"]
