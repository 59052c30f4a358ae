"""Edge sharding: training on graphs whose edge store is too large for
one card (counterpart of wsi_hgnn_tpu/parallel/big_graph.py).

Every rank of a process group holds the whole node arrays and the
parameters, and one contiguous slice of the padded edge arrays. A graph
whose `edge_group` names the group makes every edge-keyed reduction
(graph/ops.py: the segment softmax, the message sums, copy_u_max;
TypedGraph.rel_edge_counts and degrees; the heterogeneous models'
occupancy) all-reduce its partial result, so the UNMODIFIED models
compute the single-device answer, forward and backward. No model has a
sharded re-implementation.

  * `shard_edges(g, n)`: the edge arrays reshaped to [n, E/n];
  * `local_edges(g, mesh)`: this rank's slice on its device, marked with
    the group;
  * `sharded_apply(model, mesh, is_hetero)`: the evaluation forward;
  * `make_big_graph_train_step(...)`: augmentation, forward, loss,
    backward, gradient average, optimizer step.

Gradients: the all-reduce's backward sums over the group
(collectives.py), so each rank's gradient counts the edge path once per
rank and the replicated path once; `collectives.average_gradients`
(sum, divided by the world size) then gives the single-device gradient,
the same on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..collectives import average_gradients
from ..graph import transforms
from ..graph.typed_graph import TypedGraph, to_homogeneous
from ..models.asap import ASAPGCN
from ..models.layers import DropSource
from .mesh import Mesh

_EDGE_LEAVES = ("src", "dst", "esign", "sim", "edge_mask", "edge_weight")


def edge_shardable(model: torch.nn.Module) -> bool:
    """Whether `model` computes its single-device answer on an edge
    shard. ASAPGCN does not: its pooling reduces over raw edge slices
    (models/asap.py), outside the group-aware segment primitives."""
    return not isinstance(model, ASAPGCN)


def shard_edges(g: TypedGraph, n: int) -> TypedGraph:
    """The edge arrays reshaped to [n, E/n] (n must divide the edge
    capacity); node arrays untouched. Host (numpy) or device graphs."""
    e = g.num_edges
    if e % n:
        raise ValueError(f"edge capacity {e} not divisible by {n} devices")
    return g.replace(**{
        f: None if getattr(g, f) is None
        else getattr(g, f).reshape((n, e // n) + tuple(getattr(g, f).shape[1:]))
        for f in _EDGE_LEAVES})


def local_shard(g_sharded: TypedGraph, mesh: Mesh) -> TypedGraph:
    """This rank's row of a `shard_edges` graph, on the rank's device,
    with `edge_group` set to the mesh's group. The graph is host numpy or
    CPU tensors."""
    g = g_sharded.replace(**{
        f: None if getattr(g_sharded, f) is None
        else getattr(g_sharded, f)[mesh.rank] for f in _EDGE_LEAVES})
    return g.to_torch(mesh.device).replace(edge_group=mesh.group)


def local_edges(g: TypedGraph, mesh: Mesh) -> TypedGraph:
    """shard_edges over the world, then this rank's slice."""
    return local_shard(shard_edges(g, mesh.world), mesh)


def sharded_apply(model: torch.nn.Module, mesh: Mesh,
                  is_hetero: bool = True) -> Callable:
    """`fwd(g_sharded) -> logits`: the evaluation forward of `model` on
    this rank's slice of a shard_edges graph. Differentiable."""

    def fwd(g_sharded: TypedGraph) -> torch.Tensor:
        g = local_shard(g_sharded, mesh)
        if not is_hetero:
            g = to_homogeneous(g)
        model.eval()
        return model(g)

    return fwd


def make_big_graph_train_step(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer, loss_fcn,
                              is_hetero: bool, mesh: Mesh,
                              augment: bool = True) -> Callable:
    """`step(g_local, labels, weights, generator) -> (loss, probs)` in
    place on `model` and `optimizer`, with `g_local` this rank's slice
    (`local_edges`). The trainer's TypedGraph step on the shard: every
    rank draws its augmentation and dropout masks from `generator`, which
    must start from one seed on every rank, so the node masks, feature
    masks and dropout agree; DropEdge draws over the local slice, as the
    JAX package does (a different but equally distributed edge subset).
    `augment=False` gives the single-device step's parameters. Gradients
    are averaged over the group (one all-reduce) before the update."""
    if not edge_shardable(model):
        raise ValueError(f"{type(model).__name__} cannot run on an edge "
                         "shard (its pooling reduces over raw edge slices)")

    def step(g: TypedGraph, labels: torch.Tensor, weights: torch.Tensor,
             generator: torch.Generator):
        if g.edge_group is None:
            raise ValueError("the graph is not an edge shard; use "
                             "local_edges")
        if not is_hetero:
            g = to_homogeneous(g)
        if augment:
            g = transforms.train_transform(g, generator)
        model.train()
        optimizer.zero_grad(set_to_none=False)
        logits = model(g, DropSource(generator))
        loss = loss_fcn(logits, labels, weights)
        loss.backward()
        average_gradients(model.parameters(), mesh.group, mesh.world)
        optimizer.step()
        return loss.detach(), torch.softmax(logits.detach(), -1)

    return step
