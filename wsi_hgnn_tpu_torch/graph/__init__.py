"""Graph layer of the port: the padded TypedGraph, batching, augmentation,
segment ops, per-node-type linears and device-side construction."""
from .batch import batch_graphs, sort_graph_edges
from .build import build_batch_device, build_graph
from .ops import TypeSort, make_type_sort, typed_linear, typed_linear_ragged
from .typed_graph import (TypedGraph, bucket_size, from_arrays, repad_graph,
                          to_homogeneous, unstack)

__all__ = ["TypeSort", "TypedGraph", "batch_graphs", "bucket_size",
           "build_batch_device", "build_graph", "from_arrays", "make_type_sort",
           "repad_graph", "sort_graph_edges", "to_homogeneous",
           "typed_linear", "typed_linear_ragged", "unstack"]
