"""Graph helpers of the port: the host-side slide graph, size buckets and
per-node-type linears."""
from .ops import TypeSort, make_type_sort, typed_linear, typed_linear_ragged
from .typed_graph import TypedGraph, bucket_size, from_arrays

__all__ = ["TypeSort", "TypedGraph", "bucket_size", "from_arrays",
           "make_type_sort", "typed_linear", "typed_linear_ragged"]
