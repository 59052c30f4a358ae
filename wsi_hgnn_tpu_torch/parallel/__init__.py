"""Several devices: the featurizer's data parallelism in one process, and
data-parallel and edge-sharded training over a `torch.distributed`
process group (counterpart of wsi_hgnn_tpu/parallel/). The collectives
themselves are in collectives.py."""
from .big_graph import (local_edges, local_shard, make_big_graph_train_step,
                        shard_edges, sharded_apply)
from .dp import (make_dp_lattice_train_step, make_dp_train_step, place_state,
                 rank_generator)
from .mesh import (DATA_AXIS, Mesh, make_dp_featurizer, make_mesh,
                   make_sharded_batch_apply, shard_stacked, stack_graphs)

__all__ = [
    "DATA_AXIS", "Mesh", "make_mesh", "make_sharded_batch_apply",
    "make_dp_featurizer", "stack_graphs", "shard_stacked",
    "make_dp_train_step", "make_dp_lattice_train_step", "place_state",
    "rank_generator", "make_big_graph_train_step", "shard_edges",
    "local_edges", "local_shard", "sharded_apply",
]
