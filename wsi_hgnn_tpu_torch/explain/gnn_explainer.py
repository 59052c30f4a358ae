"""GNNExplainer over the TypedGraph: learned node-feature and edge masks
(counterpart of wsi_hgnn_tpu/explain/gnn_explainer.py).

The edge mask reaches the messages through `TypedGraph.edge_weight`; the
node mask scales the features. `epochs` Adam steps on the sigmoid mask
logits (torch.optim.Adam, which equals optax.adam) minimise the
prediction term plus size and entropy regularisers, on the graph's
device, with the model's own parameters frozen for the loop.

Fidelity notes (as the JAX package):
  * the prediction term is -logits[pred_label] on the RAW logits;
  * the regularisers average over REAL nodes and edges only, and the
    edge-mask init std, sqrt(2) * sqrt(2 / (2 * n_real)), uses the real
    node count; the node init is N(0, 1) * 0.1;
  * the constructor's feat_size default 0.1 overrides PARAMS' 0.5.
The JAX package draws the init from jax.random.PRNGKey(seed), which torch
cannot reproduce: here it comes from a torch.Generator seeded with `seed`
on the graph's device, or from `init_logits` (node [N], edge [E]) when
given, so both packages can start from one point.
"""
from __future__ import annotations

from math import sqrt
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.typed_graph import TypedGraph

PARAMS = {
    "edge_size": 0.005,
    "feat_size": 0.5,
    "edge_ent": 1.0,
    "feat_ent": 0.1,
    "eps": 1e-15,
}


def explainer_loss(model_fn, g: TypedGraph, node_logits: torch.Tensor,
                   edge_logits: torch.Tensor, pred_label: int, edge_size,
                   feat_size, edge_ent, feat_ent, eps) -> torch.Tensor:
    """The reference loss, term for term."""
    mn, me = torch.sigmoid(node_logits), torch.sigmoid(edge_logits)
    logits = model_fn(g.replace(edge_weight=me), g.feat * mn[:, None])
    loss = -logits.reshape(-1)[pred_label]
    em = g.edge_mask.to(me.dtype)
    nm = g.node_mask.to(mn.dtype)
    n_e, n_n = em.sum().clamp_min(1.0), nm.sum().clamp_min(1.0)
    loss = loss + (me * em).sum() * edge_size
    ent_e = -me * torch.log(me + eps) - (1 - me) * torch.log(1 - me + eps)
    loss = loss + edge_ent * (ent_e * em).sum() / n_e
    loss = loss + (mn * nm).sum() / n_n * feat_size
    ent_n = -mn * torch.log(mn + eps) - (1 - mn) * torch.log(1 - mn + eps)
    return loss + feat_ent * (ent_n * nm).sum() / n_n


class GNNExplainer:
    def __init__(self, graph: TypedGraph, model_fn, num_hops: int,
                 epochs: int = 100, lr: float = 0.01,
                 mask_threshold: float = 0.5,
                 edge_size: float = 0.005, feat_size: float = 0.1,
                 seed: int = 0, model: Optional[torch.nn.Module] = None,
                 init_logits: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        """model_fn(graph, feat_override=None) -> logits [1, C], a closure
        over trained weights; `model`, when given, is the module whose
        parameters are frozen during the loop."""
        self.g = graph
        self.model_fn = model_fn
        self.model = model
        self.epochs = epochs
        self.lr = lr
        self.threshold = mask_threshold
        self.num_hops = num_hops
        self.params = dict(PARAMS, edge_size=edge_size, feat_size=feat_size)
        self.seed = seed
        self.init_logits = init_logits

    def initial_logits(self) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self.g
        dev = g.feat.device
        if self.init_logits is not None:
            return tuple(torch.as_tensor(np.asarray(a), dtype=g.feat.dtype,
                                         device=dev)
                         for a in self.init_logits)
        n_real = int(g.node_mask.sum())
        std = sqrt(2.0) * sqrt(2.0 / (2 * max(n_real, 1)))
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        node = torch.randn(g.num_nodes, generator=gen, device=dev) * 0.1
        edge = torch.randn(g.num_edges, generator=gen, device=dev) * std
        return node.to(g.feat.dtype), edge.to(g.feat.dtype)

    def explain_node(self, node_idx: Optional[int] = None
                     ) -> Tuple[TypedGraph, np.ndarray]:
        """node_idx=None: graph classification (the pipeline's only use).
        Returns (graph with the learned edge_weight, node mask [n_real] in
        [0, 1])."""
        if node_idx is not None:
            raise NotImplementedError(
                "node-level explanation subgraphs are not wired; the "
                "reference pipeline only calls explain_node(None)")
        g = self.g
        with torch.no_grad():
            logits = self.model_fn(g, None)
        pred_label = int(logits.argmax(-1).reshape(-1)[0])
        node0, edge0 = self.initial_logits()
        node_l = node0.clone().requires_grad_(True)
        edge_l = edge0.clone().requires_grad_(True)
        opt = torch.optim.Adam([node_l, edge_l], lr=self.lr)
        p = self.params
        frozen = ([] if self.model is None else
                  [q for q in self.model.parameters() if q.requires_grad])
        for q in frozen:
            q.requires_grad_(False)
        try:
            for _ in range(self.epochs):
                opt.zero_grad()
                explainer_loss(self.model_fn, g, node_l, edge_l, pred_label,
                               p["edge_size"], p["feat_size"], p["edge_ent"],
                               p["feat_ent"], p["eps"]).backward()
                opt.step()
        finally:
            for q in frozen:
                q.requires_grad_(True)
        with torch.no_grad():
            node_mask = torch.sigmoid(node_l).cpu().numpy()
            out_g = g.replace(edge_weight=torch.sigmoid(edge_l))
        real = int(g.node_mask.sum())
        return out_g, node_mask[:real]
