"""Training-time graph augmentation as mask operations (counterpart of
wsi_hgnn_tpu/graph/transforms.py): the reference's DropNode(0.5) ->
DropEdge(0.5) -> NodeShuffle -> FeatMask(0.5), on the device form of a
TypedGraph.

Each transform is split in two: drawing its Bernoulli keep-mask from an
explicit `torch.Generator` on the graph's device, and applying a given
mask, so a test can feed the masks the JAX package drew. Shapes never
change: dropping clears masks.

  * DropNode clears a node and every incident edge.
  * DropEdge thins the surviving edges; self-loops (src == dst, the
    explicit loops of homogeneous graphs) are exempt, because the
    reference adds its self-loops after augmenting.
  * NodeShuffle permutes node ids, an isomorphism every model here is
    invariant to: the identity.
  * FeatMask zeroes each feature column with probability p.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import gather
from .typed_graph import TypedGraph


class TrainMasks(NamedTuple):
    """The three keep-masks of one augmentation."""

    keep_node: torch.Tensor  # [N] bool
    keep_edge: torch.Tensor  # [E] bool
    keep_col: torch.Tensor   # [D] bool


def keep_mask(shape, keep_prob: float, generator: torch.Generator
              ) -> torch.Tensor:
    """Bernoulli(keep_prob) on the generator's device (uniform <
    keep_prob, as jax.random.bernoulli)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u < keep_prob


def drop_node(g: TypedGraph, keep: torch.Tensor) -> TypedGraph:
    edge_mask = g.edge_mask & gather(keep, g.src) & gather(keep, g.dst)
    return g.replace(node_mask=g.node_mask & keep, edge_mask=edge_mask)


def drop_edge(g: TypedGraph, keep: torch.Tensor,
              protect_self_loops: bool = True) -> TypedGraph:
    if protect_self_loops:
        keep = keep | (g.src == g.dst)
    return g.replace(edge_mask=g.edge_mask & keep)


def feat_mask(g: TypedGraph, keep_col: torch.Tensor) -> TypedGraph:
    return g.replace(feat=g.feat * keep_col[None, :].to(g.feat.dtype))


def draw_train_masks(g: TypedGraph, generator: torch.Generator,
                     p: float = 0.5) -> TrainMasks:
    return TrainMasks(keep_mask((g.num_nodes,), 1.0 - p, generator),
                      keep_mask((g.num_edges,), 1.0 - p, generator),
                      keep_mask((g.feat_dim,), 1.0 - p, generator))


def apply_train_masks(g: TypedGraph, masks: TrainMasks) -> TypedGraph:
    """The augmentation pipeline with given masks."""
    g = drop_node(g, masks.keep_node)
    g = drop_edge(g, masks.keep_edge)
    return feat_mask(g, masks.keep_col)


def train_transform(g: TypedGraph, generator: torch.Generator,
                    p: float = 0.5) -> TypedGraph:
    """Draw, then apply."""
    return apply_train_masks(g, draw_train_masks(g, generator, p))
