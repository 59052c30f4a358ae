"""HEAT models on the regular KNN edge lattice (counterpart of
wsi_hgnn_tpu/models/lattice.py), for training, evaluation and serving.

KNN construction gives every node exactly k = radius-1 out-edges, so a
slide graph is a [B, N, k] lattice: edge (b, i, j) runs from node i to its
j-th neighbour idx[b, i, j]. The JAX package turns each reduction over
destinations into a GEMM against a [B, N*k, N] one-hot matrix, a TPU
workaround; here the reductions are O(E) `index_add_` / `scatter_reduce_`
over flattened destination ids, which the card does natively.

Randomness is explicit, as in the JAX package: the training augmentation
(`draw_train_masks`) and the dropout on `a_linears`' output draw from a
`torch.Generator` the caller passes, never from torch's global RNG, and
either can be handed precomputed masks instead.

Submodule and parameter names follow the flax trees (adapt_ws, gcs_{i},
linears_prediction, attn_{k}, head_2/head_1/head), so `convert` maps a
flax checkpoint onto these modules name for name.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.ops import make_type_sort
from .layers import LinearAttentionBlock, TypedDense, TypedHeads

_CLAMP = 60.0
_NEG_INF = -1e30


class LatticeGraph(NamedTuple):
    """A cohort of KNN slide graphs in [B, N, k] lattice form; emask marks
    the live edge slots and every consumer masks by it."""

    feats: torch.Tensor   # [B, N, D] f32
    ntypes: torch.Tensor  # [B, N] int64
    mask: torch.Tensor    # [B, N] bool
    idx: torch.Tensor     # [B, N, k] int64, j-th neighbour of node i
    sim: torch.Tensor     # [B, N, k] f32, pearson r of (i, idx[i, j])
    esign: torch.Tensor   # [B, N, k] int64
    emask: torch.Tensor   # [B, N, k] bool


def build_lattice_device(features, node_types, mask, radius: int,
                         n_node_types: int = 6,
                         knn_impl: str = "exact") -> LatticeGraph:
    """KNN + Pearson construction in lattice form, one KNN per slide.
    Buckets past STREAM_THRESHOLD compute Pearson from gathered neighbour
    rows instead of the [N, N] gram."""
    from ..ops.knn import STREAM_THRESHOLD, knn_lookup
    from ..ops.pearson import center_normalize, pearson_sim_at

    del n_node_types  # typing lives on the models, as in the JAX package
    k = radius - 1
    b, n, _ = features.shape
    idx_all, sim_all = [], []
    for s in range(b):
        idx, _ = knn_lookup(features[s], k, mask[s], impl=knn_impl)
        idx = idx.long()
        if n >= STREAM_THRESHOLD:
            sim = pearson_sim_at(features[s], idx)
        else:
            fn = center_normalize(features[s])
            sim = torch.gather(fn @ fn.T, 1, idx)
        idx_all.append(idx)
        sim_all.append(sim)
    idx = torch.stack(idx_all)
    sim = torch.stack(sim_all)
    esign = (sim > 0).long()
    emask = mask[:, :, None] & torch.gather(mask, 1, idx.reshape(b, -1)
                                            ).reshape(b, n, k)
    # tiny slides (n_real <= k) select the query itself; drop those edges
    emask = emask & (idx != torch.arange(n, device=idx.device)[None, :, None])
    return LatticeGraph(features, node_types.long(), mask, idx, sim, esign,
                        emask)


class TrainMasks(NamedTuple):
    """The three Bernoulli keep-masks of one training augmentation."""

    keep_node: torch.Tensor  # [B, N] bool (DropNode)
    keep_edge: torch.Tensor  # [B, N, k] bool (DropEdge)
    keep_col: torch.Tensor   # [D] bool (FeatMask)


def _keep(shape, keep_prob: float, generator: torch.Generator):
    """Bernoulli(keep_prob) draw on the generator's device (uniform <
    keep_prob, as jax.random.bernoulli)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u < keep_prob


def draw_train_masks(g: LatticeGraph, generator: torch.Generator,
                     p: float = 0.5) -> TrainMasks:
    """Draw the augmentation's masks from `generator` (on g's device)."""
    b, n, k = g.idx.shape
    return TrainMasks(_keep((b, n), 1.0 - p, generator),
                      _keep((b, n, k), 1.0 - p, generator),
                      _keep((g.feats.shape[-1],), 1.0 - p, generator))


def apply_train_masks(g: LatticeGraph, masks: TrainMasks) -> LatticeGraph:
    """The reference's training augmentation (DropNode -> DropEdge ->
    NodeShuffle -> FeatMask) on the lattice form, with given masks: a
    dropped node clears itself and every incident edge, DropEdge thins the
    survivors (self-edges exempt), NodeShuffle is the identity
    isomorphism, FeatMask zeroes feature columns."""
    b, n, k = g.idx.shape
    keep_n = masks.keep_node
    mask = g.mask & keep_n
    keep_dst = torch.gather(keep_n, 1, g.idx.reshape(b, -1)).reshape(b, n, k)
    emask = g.emask & keep_n[:, :, None] & keep_dst
    self_loop = g.idx == torch.arange(n, device=g.idx.device)[None, :, None]
    emask = emask & (masks.keep_edge | self_loop)
    feats = g.feats * masks.keep_col.to(g.feats.dtype)[None, None, :]
    return g._replace(feats=feats, mask=mask, emask=emask)


def lattice_train_transform(g: LatticeGraph, generator: torch.Generator,
                            p: float = 0.5) -> LatticeGraph:
    """Counterpart of the JAX lattice_train_transform: draw, then apply."""
    return apply_train_masks(g, draw_train_masks(g, generator, p))


def _flat_dst(g: LatticeGraph) -> torch.Tensor:
    """[B*N*k] destination ids into the flattened [B*N] node axis."""
    b, n, k = g.idx.shape
    base = torch.arange(b, device=g.idx.device)[:, None, None] * n
    return (g.idx + base).reshape(-1)


def _rel_presence(g: LatticeGraph, t: int, per_graph: bool = False):
    """(dst_denom [B, T] f32, type_present [B, T] bool): relation and node
    type occupancy, per slide (per_graph, the serving semantics) or over
    the whole batch (the batched-training semantics)."""
    b, n, k = g.idx.shape
    dty = torch.gather(g.ntypes, 1, g.idx.reshape(b, -1)).reshape(b, n, k)
    rel = g.esign * t * t + g.ntypes[:, :, None] * t + dty
    counts = torch.zeros(b, 2 * t * t, dtype=torch.long, device=rel.device)
    counts.scatter_add_(1, rel.reshape(b, -1), g.emask.reshape(b, -1).long())
    node_counts = torch.zeros(b, t, dtype=torch.long, device=rel.device)
    node_counts.scatter_add_(1, g.ntypes, g.mask.long())
    present = counts > 0
    if not per_graph:
        present = present.any(0, keepdim=True).expand(b, -1)
        node_counts = node_counts.sum(0, keepdim=True).expand(b, -1)
    # rel = esign*t*t + src*t + dst: as [2t, t] the DESTINATION type is last
    dst_denom = present.reshape(b, 2 * t, t).sum(1).float()
    return dst_denom, node_counts > 0


def edge_softmax(g: LatticeGraph, score: torch.Tensor, t: int) -> torch.Tensor:
    """Attention weights [B, N, k, H] of edge scores [B, N, k, H]: a
    softmax over each (destination, esign * t + source type, head) group
    of live edges, logits clamped to +-60.

    Clipping alone is not shift invariant, so when some live logit nears
    the clamp the scores are shifted by one max per destination (it
    cancels in every group at that destination). The JAX package takes
    that branch under lax.cond; here both branches are computed and
    selected on the device, with no host sync. The shift is a constant
    for autograd, as under the JAX stop_gradient: where a group straddles
    the clamp a shift that carried a gradient would change the gradients."""
    b, n, k = g.idx.shape
    n_h = score.shape[-1]
    dst = _flat_dst(g)
    with torch.no_grad():
        edge_max = torch.where(g.emask, score.amax(-1), -math.inf).reshape(-1)
        dmax = torch.full((b * n,), -math.inf, dtype=score.dtype,
                          device=score.device)
        dmax = dmax.scatter_reduce(0, dst, edge_max, "amax")
        dmax = torch.where(torch.isfinite(dmax), dmax, 0.0)
    shifted = score - dmax[dst].reshape(b, n, k, 1)
    hot = torch.where(g.emask[..., None], score.abs(), 0.0).amax()
    score = torch.where(hot > 0.9 * _CLAMP, shifted, score)
    score = score.clamp(-_CLAMP, _CLAMP)
    exp_s = torch.where(g.emask[..., None], torch.exp(score), 0.0)

    # softmax denominators per (dst, combo, head), combo = esign*t + src type
    n_combo = 2 * t
    combo = (g.esign * t + g.ntypes[:, :, None]).reshape(-1)
    slot = dst * n_combo + combo
    den = torch.zeros(b * n * n_combo, n_h, dtype=score.dtype,
                      device=score.device)
    den.index_add_(0, slot, exp_s.reshape(-1, n_h))
    den_sel = den[slot].reshape(b, n, k, n_h)
    # double-where division: den_sel is 0 on edges into padded nodes
    den_pos = den_sel > 0
    return torch.where(den_pos, exp_s / torch.where(den_pos, den_sel, 1.0),
                       0.0)


class HEATLayerLattice(nn.Module):
    """One HEAT layer on the lattice (flax HEATLayerLattice's tree)."""

    def __init__(self, n_types: int, in_dim: int, out_dim: int, n_heads: int,
                 dropout: float = 0.2, typed_impl: str = "ragged"):
        super().__init__()
        self.n_types, self.out_dim, self.n_heads = n_types, out_dim, n_heads
        self.dropout = float(dropout)
        for name in ("k_linears", "q_linears", "v_linears"):
            self.add_module(name, TypedDense(n_types, in_dim, out_dim,
                                             typed_impl))
        self.a_linears = TypedDense(n_types, out_dim, out_dim, typed_impl)
        self.skip = nn.Parameter(torch.ones(n_types))
        self.e_linear = nn.Linear(1, 1)

    def forward(self, g: LatticeGraph, h, dst_denom, tsort=None,
                generator: Optional[torch.Generator] = None,
                drop_mask: Optional[torch.Tensor] = None):
        t = self.n_types
        b, n, k = g.idx.shape
        n_h, d_k = self.n_heads, self.out_dim // self.n_heads
        flat_h = h.reshape(b * n, -1)
        flat_ty = g.ntypes.reshape(-1)
        kv = self.k_linears(flat_h, flat_ty, tsort).reshape(b, n, n_h, d_k)
        qv = self.q_linears(flat_h, flat_ty, tsort)
        vv = self.v_linears(flat_h, flat_ty, tsort).reshape(b, n, n_h, d_k)
        dst = _flat_dst(g)

        # per-edge scores q[dst] . k[src]: [B, N, k, H]
        q_dst = qv[dst].reshape(b, n, k, n_h, d_k)
        ea = self.e_linear(g.sim[..., None])[..., 0]
        score = (q_dst * kv[:, :, None]).sum(-1) * ea[..., None] / math.sqrt(d_k)
        attn = edge_softmax(g, score, t)

        msg = (attn[..., None] * vv[:, :, None]).reshape(-1, self.out_dim)
        agg = torch.zeros(b * n, self.out_dim, device=h.device)
        agg.index_add_(0, dst, msg)

        denom = torch.gather(dst_denom.clamp_min(1.0), 1, g.ntypes).reshape(-1, 1)
        trans = self.a_linears(agg / denom, flat_ty, tsort)
        if self.training and self.dropout > 0.0:
            if drop_mask is None:
                if generator is None:
                    raise ValueError("training-mode dropout draws from an "
                                     "explicit generator; pass generator=")
                drop_mask = _keep(trans.shape, 1.0 - self.dropout, generator)
            trans = torch.where(drop_mask, trans / (1.0 - self.dropout), 0.0)
        alpha = torch.sigmoid(self.skip)[flat_ty][:, None]
        mixed = trans * alpha + flat_h * (1.0 - alpha)
        has_update = torch.gather(dst_denom > 0, 1, g.ntypes).reshape(-1)
        keep = (has_update & g.mask.reshape(-1))[:, None]
        return torch.where(keep, mixed, flat_h).reshape(b, n, self.out_dim)


def _pool_by_type(g: LatticeGraph, h, t: int, kind: str = "mean"):
    """[B, T, D] per-(graph, type) readout; empty types read out 0."""
    ty_oh = F.one_hot(g.ntypes, t).to(h.dtype) * g.mask[..., None]
    if kind in ("mean", "sum"):
        sums = torch.einsum("bnt,bnd->btd", ty_oh, h)
        if kind == "sum":
            return sums
        return sums / ty_oh.sum(1).clamp_min(1.0)[..., None]
    if kind == "max":
        vals = torch.where((ty_oh > 0)[..., None], h[:, :, None, :], _NEG_INF)
        out = vals.amax(1)
        return torch.where(out <= _NEG_INF / 2, 0.0, out)
    raise NotImplementedError(f"per-ntype pooling {kind!r}")


class _HEATLattice(nn.Module):
    """The trunk HEATNet2Lattice and HEATNet4Lattice share: typed input
    projection, HEAT layers, per-type pooling."""

    def __init__(self, in_dim, hidden_dim, n_layers, n_heads, n_node_types,
                 dropout, graph_pooling_type, typed_impl, presence):
        super().__init__()
        if presence not in ("batch", "graph"):
            raise ValueError(f"unknown presence {presence!r}")
        self.n_types = n_node_types
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.graph_pooling_type = graph_pooling_type
        self.typed_impl = typed_impl
        self.presence = presence
        self.adapt_ws = TypedDense(n_node_types, in_dim, hidden_dim, typed_impl)
        for i in range(n_layers):
            self.add_module(f"gcs_{i}", HEATLayerLattice(
                n_node_types, hidden_dim, hidden_dim, n_heads, dropout,
                typed_impl))

    def draw_dropout_masks(self, g: LatticeGraph, generator: torch.Generator
                           ) -> Optional[List[torch.Tensor]]:
        """One [B*N, hidden] keep-mask per HEAT layer, drawn as the layers
        would draw them in training; None when dropout is off."""
        p = self.gcs_0.dropout if self.n_layers else 0.0
        if p <= 0.0:
            return None
        b, n, _ = g.feats.shape
        return [_keep((b * n, self.hidden_dim), 1.0 - p, generator)
                for _ in range(self.n_layers)]

    def trunk(self, g: LatticeGraph, generator=None, drop_masks=None):
        t = self.n_types
        b, n, _ = g.feats.shape
        dst_denom, type_present = _rel_presence(
            g, t, per_graph=self.presence == "graph")
        flat_ty = g.ntypes.reshape(-1)
        tsort = (make_type_sort(flat_ty, t) if self.typed_impl == "ragged"
                 else None)
        h = self.adapt_ws(g.feats.reshape(b * n, -1), flat_ty, tsort)
        h = h.reshape(b, n, self.hidden_dim)
        for i in range(self.n_layers):
            h = getattr(self, f"gcs_{i}")(
                g, h, dst_denom, tsort, generator=generator,
                drop_mask=None if drop_masks is None else drop_masks[i])
        pooled = _pool_by_type(g, h, t, self.graph_pooling_type)
        return pooled, type_present.to(g.feats.dtype)


class HEATNet4Lattice(_HEATLattice):
    """models.HEATNet4 on the lattice. presence 'batch' (batched training
    occupancy) | 'graph' (per-slide occupancy: evaluation and serving)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, n_heads: int, n_node_types: int,
                 dropout: float = 0.2, graph_pooling_type: str = "mean",
                 embed_dim: int = 256, typed_impl: str = "ragged",
                 presence: str = "batch"):
        super().__init__(in_dim, hidden_dim, n_layers, n_heads, n_node_types,
                         dropout, graph_pooling_type, typed_impl, presence)
        t = n_node_types
        self.linears_prediction = TypedHeads(t, hidden_dim, embed_dim)
        for kk in range(t):
            self.add_module(f"attn_{kk}", LinearAttentionBlock(embed_dim))
        self.head_2 = nn.Linear(t * embed_dim, embed_dim)
        self.head_1 = nn.Linear(embed_dim, 64)
        self.head = nn.Linear(64, out_dim)

    def forward(self, g: LatticeGraph, generator=None, drop_masks=None):
        """Logits [B, C]. In training mode the dropout draws from
        `generator` unless `drop_masks` (one per layer) are given."""
        pooled, pres = self.trunk(g, generator, drop_masks)
        out_h = self.linears_prediction(pooled) * pres[:, :, None]
        hg = out_h.sum(1)
        gated = [getattr(self, f"attn_{kk}")(out_h[:, kk], hg)
                 * pres[:, kk:kk + 1] for kk in range(self.n_types)]
        x = self.head_2(torch.cat(gated, dim=1))
        return self.head(self.head_1(x))


class HEATNet2Lattice(_HEATLattice):
    """models.HEATNet2 on the lattice."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int, n_heads: int, n_node_types: int,
                 dropout: float = 0.2, graph_pooling_type: str = "mean",
                 typed_impl: str = "ragged", presence: str = "batch"):
        super().__init__(in_dim, hidden_dim, n_layers, n_heads, n_node_types,
                         dropout, graph_pooling_type, typed_impl, presence)
        self.linears_prediction = TypedHeads(n_node_types, hidden_dim, out_dim)

    def forward(self, g: LatticeGraph, generator=None, drop_masks=None):
        pooled, pres = self.trunk(g, generator, drop_masks)
        return (self.linears_prediction(pooled) * pres[:, :, None]).sum(1)
