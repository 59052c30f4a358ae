"""Models of the port: lattice HEAT, layers, CNN featurizers."""
from .lattice import (HEATLayerLattice, HEATNet2Lattice, HEATNet4Lattice,
                      LatticeGraph, build_lattice_device)
from .layers import LinearAttentionBlock, TypedDense, TypedHeads

__all__ = ["HEATLayerLattice", "HEATNet2Lattice", "HEATNet4Lattice",
           "LatticeGraph", "LinearAttentionBlock", "TypedDense", "TypedHeads",
           "build_lattice_device"]
