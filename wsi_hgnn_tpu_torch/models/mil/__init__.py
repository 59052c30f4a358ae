"""The MIL baselines of the port (counterparts in wsi_hgnn_tpu/models/mil):
ABMIL, DSMIL, ReMix reduction and augmentation, the GTNMIL
GraphTransformer with its GraphCAM (transformer LRP, relprop.py), H2MIL
over multi-resolution trees, and SimCLR's contrastive training step."""
from .abmil import ABMIL, GatedABMIL
from .bags import pad_bag
from .dsmil import DSMIL, BClassifier, IClassifier
from .graph_transformer import (GCNBlock, GraphTransformer, TransformerBlock,
                                dense_mincut_pool, graphcam)
from .h2mil import H2MIL, IHPool, RAConvLayer, TreeGraph
from .remix import kmeans, mix_aug, mix_the_bag_aug, reduce_bag
from .simclr import (augment_pair, coords_from_patch_names, nt_xent_loss,
                     simclr_train_step, spatial_adjacency)

__all__ = [
    "ABMIL", "GatedABMIL", "pad_bag",
    "DSMIL", "BClassifier", "IClassifier",
    "GCNBlock", "GraphTransformer", "TransformerBlock", "dense_mincut_pool",
    "graphcam",
    "H2MIL", "IHPool", "RAConvLayer", "TreeGraph",
    "kmeans", "mix_aug", "mix_the_bag_aug", "reduce_bag",
    "augment_pair", "coords_from_patch_names", "nt_xent_loss",
    "simclr_train_step", "spatial_adjacency",
]
