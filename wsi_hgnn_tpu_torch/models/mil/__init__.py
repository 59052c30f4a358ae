"""The MIL baselines of the port (counterparts in wsi_hgnn_tpu/models/mil):
ABMIL, DSMIL, ReMix reduction and augmentation, the GTNMIL
GraphTransformer. H2MIL, GraphCAM and the SimCLR training step wait for
the next slice (ROADMAP.md)."""
from .abmil import ABMIL, GatedABMIL
from .bags import pad_bag
from .dsmil import DSMIL, BClassifier, IClassifier
from .graph_transformer import (GCNBlock, GraphTransformer, TransformerBlock,
                                dense_mincut_pool)
from .remix import kmeans, mix_aug, mix_the_bag_aug, reduce_bag
from .simclr import coords_from_patch_names, spatial_adjacency

__all__ = [
    "ABMIL", "GatedABMIL", "pad_bag",
    "DSMIL", "BClassifier", "IClassifier",
    "GCNBlock", "GraphTransformer", "TransformerBlock", "dense_mincut_pool",
    "kmeans", "mix_aug", "mix_the_bag_aug", "reduce_bag",
    "coords_from_patch_names", "spatial_adjacency",
]
