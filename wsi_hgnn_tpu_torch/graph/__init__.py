"""Graph helpers of the port: size buckets and per-node-type linears."""
from .ops import TypeSort, make_type_sort, typed_linear, typed_linear_ragged
from .typed_graph import bucket_size

__all__ = ["TypeSort", "bucket_size", "make_type_sort", "typed_linear",
           "typed_linear_ragged"]
