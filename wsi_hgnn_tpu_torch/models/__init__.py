"""Models of the port: lattice HEAT, layers, CNN featurizers."""
from .lattice import (HEATLayerLattice, HEATNet2Lattice, HEATNet4Lattice,
                      LatticeGraph, TrainMasks, apply_train_masks,
                      build_lattice_device, draw_train_masks,
                      lattice_train_transform)
from .layers import LinearAttentionBlock, TypedDense, TypedHeads

__all__ = ["HEATLayerLattice", "HEATNet2Lattice", "HEATNet4Lattice",
           "LatticeGraph", "LinearAttentionBlock", "TrainMasks", "TypedDense",
           "TypedHeads", "apply_train_masks", "build_lattice_device",
           "draw_train_masks", "lattice_train_transform"]
