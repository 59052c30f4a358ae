"""Models of the port: the TypedGraph GNN zoo, ASAPGCN, lattice HEAT,
layers, the MLP baselines, CNN featurizers."""
from .asap import ASAPGCN, ASAPPooling, LEConv
from .heterogeneous import (HEATLayer, HEATNet2, HEATNet4, HetRGCN,
                            HetRGCNLayer, HGT, HGTLayer)
from .homogeneous import (GAT, GATConvLayer, GCN, GIN, GINConvLayer, GINMLP,
                          GraphConvLayer, NTPoolGCN)
from .lattice import (HEATLayerLattice, HEATNet2Lattice, HEATNet4Lattice,
                      LatticeGraph, TrainMasks, apply_train_masks,
                      build_lattice_device, draw_train_masks,
                      lattice_train_transform)
from .layers import (DropSource, LinearAttentionBlock, MaskedBatchNorm, Pool,
                     TypedDense, TypedHeads, TypedLayerNorm, pool_all_types)
from .mlp import MLP2Layers, MLP4Layers

__all__ = ["ASAPGCN", "ASAPPooling", "DropSource", "GAT", "GATConvLayer",
           "GCN", "GIN", "GINConvLayer", "GINMLP", "GraphConvLayer",
           "HEATLayer", "HEATLayerLattice", "HEATNet2", "HEATNet2Lattice",
           "HEATNet4", "HEATNet4Lattice", "HGT", "HGTLayer", "HetRGCN",
           "HetRGCNLayer", "LEConv", "LatticeGraph", "LinearAttentionBlock",
           "MLP2Layers", "MLP4Layers", "MaskedBatchNorm", "NTPoolGCN",
           "Pool", "TrainMasks", "TypedDense", "TypedHeads",
           "TypedLayerNorm", "apply_train_masks", "build_lattice_device",
           "draw_train_masks", "lattice_train_transform", "pool_all_types"]
