"""Data layer of the port: the slide lister, slide-graph datasets, npz
storage, the TypedGraph and lattice-form host batching pipelines."""
from .datasets import (C16EvalDataset, GraphDataset, TCGACancerStageDataset,
                       TCGACancerTypingDataset, WSIData, load_graph_npz,
                       save_graph_npz)
from .lattice_loader import (LatticeLoader, lattice_batch_for_budget,
                             pack_slide, probe_lattice,
                             probe_lattice_and_capacities,
                             slide_lattice_geometry, slide_regular_k)
from .loader import GraphLoader, dataset_capacities, prefetched_batches

__all__ = ["C16EvalDataset", "GraphDataset", "GraphLoader", "LatticeLoader",
           "TCGACancerStageDataset", "TCGACancerTypingDataset", "WSIData",
           "dataset_capacities", "lattice_batch_for_budget", "load_graph_npz",
           "pack_slide", "prefetched_batches", "probe_lattice",
           "probe_lattice_and_capacities", "save_graph_npz",
           "slide_lattice_geometry", "slide_regular_k"]
