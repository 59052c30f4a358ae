"""Data layer of the port: slide-graph datasets, npz storage, the
lattice-form host batching pipeline."""
from .datasets import (GraphDataset, TCGACancerStageDataset,
                       TCGACancerTypingDataset, load_graph_npz,
                       save_graph_npz)
from .lattice_loader import (LatticeLoader, pack_slide,
                             probe_lattice_and_capacities,
                             slide_lattice_geometry)
from .loader import prefetched_batches

__all__ = ["GraphDataset", "LatticeLoader", "TCGACancerStageDataset",
           "TCGACancerTypingDataset", "load_graph_npz", "pack_slide",
           "prefetched_batches", "probe_lattice_and_capacities",
           "save_graph_npz", "slide_lattice_geometry"]
