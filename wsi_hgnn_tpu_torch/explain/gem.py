"""GEM causal explainers, node importance by leave-one-node-out loss delta
(counterpart of wsi_hgnn_tpu/explain/gem.py).

Deleting a node clears its mask bit and every incident edge; the node
stays in place, which equals dgl.remove_nodes for every model in the zoo
(pooling denominators, degrees and relation presence all derive from the
masks). The JAX package vmaps 32 deletions per chunk; here a chunk is ONE
forward of a flat batch of B copies of the slide on its device: copy b
holds the slide's N real nodes at offsets b*N (node_graph = b, n_graphs =
B; padding that trails them is left out, being masked anyway) and has
node ids[b] deleted. The tail chunk repeats its last id, so every chunk has
one shape. The batch has `per_graph_occupancy` set, so a heterogeneous
model counts relation and type occupancy per copy, as one forward of the
slide does. The scores stay on the device and are read once per slide.

Semantics (the reference's):
  * GemExplainer scores delta_i = CE(pred - pred_without_i, label), then
    min-max normalises;
  * HetGemExplainer first collapses every edge to 'pos' and scores
    delta_i = loss - loss_without_i, unnormalised, per node type. The
    collapsed graph is marked unsorted: its edges were sorted by a key
    that held the old signs.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.typed_graph import TypedGraph


def _delete_node(g: TypedGraph, nid: int) -> TypedGraph:
    """One node deleted by mask (node and incident edges cleared)."""
    ids = torch.arange(g.num_nodes, device=g.node_mask.device)
    return g.replace(node_mask=g.node_mask & (ids != nid),
                     edge_mask=g.edge_mask & (g.src != nid) & (g.dst != nid))


_NODE_LEAVES = ("feat", "node_type", "node_graph", "node_mask")
_EDGE_LEAVES = ("src", "dst", "esign", "sim", "edge_mask", "edge_weight")


def real_part(g: TypedGraph) -> TypedGraph:
    """g without its padding when the padding trails the real nodes and
    edges and no real edge touches it (as `from_arrays` pads); g
    otherwise. Padding is masked out of every result, so only the work
    changes."""
    n, e = int(g.node_mask.sum()), int(g.edge_mask.sum())
    if not (bool(g.node_mask[:n].all()) and bool(g.edge_mask[:e].all())
            and (e == 0 or int(torch.maximum(g.src[:e], g.dst[:e]).max()) < n)):
        return g
    return g.replace(**{k: getattr(g, k)[:n] for k in _NODE_LEAVES},
                     **{k: None if getattr(g, k) is None
                        else getattr(g, k)[:e] for k in _EDGE_LEAVES})


class LooBatch:
    """B copies of the device graph `g` (its real part) as one flat batch;
    `delete(ids)` returns the batch with node ids[b] deleted in copy b.
    The copied leaves are built once per slide, the masks per chunk."""

    def __init__(self, g: TypedGraph, copies: int):
        g = real_part(g)
        n, dev = g.num_nodes, g.feat.device
        self.g, self.copies = g, copies
        off = torch.arange(copies, device=dev)[:, None] * n
        self.batch = TypedGraph(
            feat=g.feat.repeat(copies, 1),
            node_type=g.node_type.repeat(copies),
            node_graph=torch.arange(copies, device=dev).repeat_interleave(n),
            node_mask=g.node_mask.repeat(copies),
            src=(g.src[None, :] + off).reshape(-1),
            dst=(g.dst[None, :] + off).reshape(-1),
            esign=g.esign.repeat(copies), sim=g.sim.repeat(copies),
            edge_mask=g.edge_mask.repeat(copies),
            edge_weight=(None if g.edge_weight is None
                         else g.edge_weight.repeat(copies)),
            n_graphs=copies, n_node_types=g.n_node_types,
            n_edge_types=g.n_edge_types, edges_sorted=False,
            per_graph_occupancy=True)

    def delete(self, ids: torch.Tensor) -> TypedGraph:
        g = self.g
        node = torch.arange(g.num_nodes, device=ids.device)
        keep_node = g.node_mask[None, :] & (node[None, :] != ids[:, None])
        keep_edge = (g.edge_mask[None, :] & (g.src[None, :] != ids[:, None])
                     & (g.dst[None, :] != ids[:, None]))
        return self.batch.replace(node_mask=keep_node.reshape(-1),
                                  edge_mask=keep_edge.reshape(-1))


def _ce(logits: torch.Tensor, label: int) -> torch.Tensor:
    """Cross-entropy of each row of [B, C] logits (or of [C]) at `label`."""
    return -F.log_softmax(logits, -1)[..., label]


@torch.no_grad()
def _loo_scores(score: Callable[[torch.Tensor], torch.Tensor],
                model_fn: Callable, g: TypedGraph,
                batch_size: int) -> np.ndarray:
    """score(alt_logits [B, C]) -> [B] for every real node, chunk by
    chunk over flat leave-one-out batches; read once."""
    n_real = int(g.node_mask.sum())
    dev = g.feat.device
    ids = torch.arange(n_real, device=dev)
    out = torch.empty(n_real, dtype=g.feat.dtype, device=dev)
    loo = LooBatch(g, batch_size)
    for s in range(0, n_real, batch_size):
        chunk = ids[s:s + batch_size]
        padded = torch.cat([chunk, chunk[-1:].expand(batch_size - len(chunk))])
        alt = model_fn(loo.delete(padded)).reshape(batch_size, -1)
        out[s:s + len(chunk)] = score(alt)[:len(chunk)]
    return out.cpu().numpy()


class GemExplainer:
    """Homogeneous GEM: model_fn(TypedGraph) -> logits [n_graphs, C]."""

    def __init__(self, graph: TypedGraph, model_fn: Callable, label: int,
                 batch_size: int = 32):
        self.graph = graph
        self.model_fn = model_fn
        self.label = int(label)
        self.batch_size = batch_size

    @torch.no_grad()
    def explain_node(self) -> np.ndarray:
        pred = self.model_fn(self.graph).reshape(1, -1)
        scores = _loo_scores(lambda alt: _ce(pred - alt, self.label),
                             self.model_fn, self.graph, self.batch_size)
        lo, hi = scores.min(), scores.max()
        return (scores - lo) / max(hi - lo, 1e-12)


class HetGemExplainer:
    """Heterogeneous GEM: edges collapsed to 'pos', per-node loss deltas."""

    def __init__(self, graph: TypedGraph, model_fn: Callable, label: int,
                 batch_size: int = 32):
        self.graph = graph.replace(esign=torch.ones_like(graph.esign),
                                   edges_sorted=False)
        self.model_fn = model_fn
        self.label = int(label)
        self.batch_size = batch_size

    @torch.no_grad()
    def flat_scores(self) -> np.ndarray:
        """Per-node scores in node order (the pixel-level evaluator aligns
        them with the patch list)."""
        loss = _ce(self.model_fn(self.graph).reshape(-1), self.label)
        return _loo_scores(lambda alt: loss - _ce(alt, self.label),
                           self.model_fn, self.graph, self.batch_size)

    def explain_node(self) -> Dict[str, np.ndarray]:
        scores = self.flat_scores()
        ntypes = self.graph.node_type[:len(scores)].cpu().numpy()
        return {str(t): scores[ntypes == t]
                for t in range(self.graph.n_node_types)}
