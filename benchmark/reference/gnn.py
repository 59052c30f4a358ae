"""The slide graph and the two GNNs, plain, on edge lists.

Graph (the reference repository's graph constructor): each node's
radius-1 nearest neighbours in feature space by L2 distance (itself
excluded, ties to the lower index) are its out-edges; each edge carries
the Pearson r of its endpoints' features as `sim` and its sign (r > 0)
as `esign`.

HEAT4 (HEAT, Chan et al., CVPR 2023): a typed input projection, HEAT
layers (typed K/Q/V; scores q[dst].k[src] * e(sim) / sqrt(dk) with e a
1 -> 1 linear map; a softmax per (destination, esign * T + source type,
head), logits clamped to +-60 with a per-destination shift once any live
logit nears the clamp; the messages' sum divided by the number of
(esign, source type) relations present into the destination's type; a
typed output map, dropout, and a sigmoid(skip) mix with the input where
that type receives any relation), a mean readout per node type, typed
prediction heads over the present types, the gating blocks (a softmax
over one entry: the identity) and three linear maps.

HGT (Hu et al., 2020), as the reference repository runs it: a typed
input projection with the exact GELU, then per layer the typed heads on
the mean readout per type (summed over the present types and the
layers), and an HGT layer: per-relation K and V transforms, a softmax per
(destination, relation), the cross-type mean, a typed output map,
dropout, the skip mix and a per-type LayerNorm. The last layer's output
reaches no head.

Occupancy (which relations and types are present) is over the graph
given: one slide when serving, the whole batch when training. Every
product goes through a `Prec` (the "tf32" control).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .precision import Prec

CLAMP = 60.0


class Graph(NamedTuple):
    """One graph, or a batch of graphs as one disjoint graph."""

    feat: torch.Tensor     # [N, D] f32
    ntype: torch.Tensor    # [N] int64
    graph: torch.Tensor    # [N] int64 graph id
    mask: torch.Tensor     # [N] bool: a live node
    src: torch.Tensor      # [E] int64
    dst: torch.Tensor      # [E] int64
    esign: torch.Tensor    # [E] int64
    sim: torch.Tensor      # [E] f32
    emask: torch.Tensor    # [E] bool: a live edge
    n_graphs: int


# ---------------------------------------------------------------------------
# the slide graph
# ---------------------------------------------------------------------------
def knn(feat: torch.Tensor, k: int, prec: Prec, tile: int = 1024):
    """[N, k] neighbour ids in ascending distance, self excluded, ties to
    the lower index."""
    n = feat.shape[0]
    sq = (feat * feat).sum(1)
    out = []
    for s in range(0, n, tile):
        q = feat[s:s + tile]
        d2 = (sq[s:s + tile, None] + sq[None, :]
              - 2.0 * prec.mm(q, feat.T)).clamp_min(0.0)
        rows = torch.arange(s, s + q.shape[0], device=feat.device)
        d2[torch.arange(q.shape[0], device=feat.device), rows] = float("inf")
        _, idx = torch.sort(d2, dim=1, stable=True)
        out.append(idx[:, :k])
    return torch.cat(out)


def pearson(feat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    c = feat - feat.mean(dim=1, keepdim=True)
    c = c / torch.linalg.vector_norm(c, dim=1, keepdim=True).clamp_min(1e-12)
    return (c[src] * c[dst]).sum(1)


def slide_edges(feat: torch.Tensor, radius: int, prec: Prec):
    """(src, dst, esign, sim) of one slide, src-major, each node's
    neighbours in ascending distance."""
    k = radius - 1
    n = feat.shape[0]
    idx = knn(feat, k, prec)
    src = torch.arange(n, device=feat.device).repeat_interleave(k)
    dst = idx.reshape(-1)
    sim = pearson(feat, src, dst)
    return src, dst, (sim > 0).long(), sim


def _graph(feat, ntype, src, dst) -> Graph:
    sim = pearson(feat, src, dst)
    n = feat.shape[0]
    dev = feat.device
    return Graph(feat, ntype.long(), torch.zeros(n, dtype=torch.long, device=dev),
                 torch.ones(n, dtype=torch.bool, device=dev), src, dst,
                 (sim > 0).long(), sim,
                 torch.ones(src.shape[0], dtype=torch.bool, device=dev), 1)


def slide_graph(feat, ntype, radius: int, prec: Prec) -> Graph:
    src, dst, _, _ = slide_edges(feat, radius, prec)
    return _graph(feat, ntype, src, dst)


# f32 evaluates a distance d2 = |x|^2 + |y|^2 - 2 x.y to within about
# this share of |x|^2 + |y|^2 (a 1024-term dot product's rounding, with
# room): candidates nearer than that to the k-th are tied in f32
TIE_RTOL = 1e-5
MAX_TIED = 6


def tie_variants(feat, ntype, radius: int):
    """Every slide graph an exact f32 KNN may build: the float64 KNN, and
    where a node's k-th and (k+1)-th candidates lie within f32 rounding of
    each other (TIE_RTOL), the graph with the two swapped, for the
    MAX_TIED closest such ties (2^m graphs). Returns [Graph]."""
    k = radius - 1
    f64 = feat.double()
    n = f64.shape[0]
    sq = (f64 * f64).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (f64 @ f64.T)
    d2.fill_diagonal_(float("inf"))
    vals, idx = torch.sort(d2, dim=1, stable=True)
    scale = sq + torch.maximum(sq[idx[:, k - 1]], sq[idx[:, k]])
    slack = (vals[:, k] - vals[:, k - 1]) / scale
    tied = (slack < TIE_RTOL).nonzero()[:, 0]
    tied = tied[torch.argsort(slack[tied])][:MAX_TIED].tolist()
    base = idx[:, :k].clone()
    src = torch.arange(n, device=feat.device).repeat_interleave(k)
    graphs = []
    for mask in range(1 << len(tied)):
        nb = base.clone()
        for bit, node in enumerate(tied):
            if mask >> bit & 1:
                nb[node, k - 1] = idx[node, k]
        graphs.append(_graph(feat, ntype, src, nb.reshape(-1)))
    return graphs


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def typed_linear(prec: Prec, x, ntype, p, t: int):
    """Each row through its own type's dense map (kernel [T, in, out])."""
    out = x.new_zeros(x.shape[0], p["kernel"].shape[-1])
    for ty in range(t):
        rows = (ntype == ty).nonzero()[:, 0]
        if rows.numel():
            out = out.index_copy(0, rows, prec.mm(x[rows], p["kernel"][ty])
                                 + p["bias"][ty])
    return out


def linear(prec: Prec, x, p):
    y = prec.mm(x, p["kernel"])
    return y + p["bias"] if "bias" in p else y


def segment_softmax(score, seg, n_seg: int, live):
    """Softmax of score [E, H] within each segment, over live edges."""
    with torch.no_grad():
        m = torch.full((n_seg, score.shape[1]), -math.inf, device=score.device)
        m = m.index_reduce(0, seg[live], score[live], "amax")
        m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(live[:, None], torch.exp(score - m[seg]), 0.0)
    den = score.new_zeros(n_seg, score.shape[1]).index_add(0, seg, e)
    return torch.where(live[:, None], e / den[seg].clamp_min(1e-30), 0.0)


def type_mean(h, g: Graph, t: int):
    """[G, T, D] mean of live nodes' rows per (graph, type); 0 if none."""
    seg = g.graph * t + g.ntype
    m = g.mask.to(h.dtype)
    sums = h.new_zeros(g.n_graphs * t, h.shape[1]).index_add(0, seg, h * m[:, None])
    cnt = h.new_zeros(g.n_graphs * t).index_add(0, seg, m)
    return (sums / cnt.clamp_min(1.0)[:, None]).reshape(g.n_graphs, t, -1)


def _presence(g: Graph, t: int, n_rel_src: int, rel_of_edge, per_graph: bool):
    """(relations present [G', R], types present [G', T]) over the batch
    (G' = 1) or per graph."""
    gid = g.graph[g.src] if per_graph else torch.zeros_like(g.src)
    n_g = g.n_graphs if per_graph else 1
    rel = gid * n_rel_src + rel_of_edge
    cnt = torch.zeros(n_g * n_rel_src, dtype=torch.long, device=g.src.device)
    cnt = cnt.index_add(0, rel, g.emask.long())
    ng = g.graph if per_graph else torch.zeros_like(g.graph)
    tcnt = torch.zeros(n_g * t, dtype=torch.long, device=g.src.device)
    tcnt = tcnt.index_add(0, ng * t + g.ntype, g.mask.long())
    return cnt.reshape(n_g, n_rel_src) > 0, tcnt.reshape(n_g, t) > 0


def _dropout(x, keep: Optional[torch.Tensor], rate: float):
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


# ---------------------------------------------------------------------------
# HEAT4
# ---------------------------------------------------------------------------
def heat4_logits(w: Dict, g: Graph, gnn: Dict, prec: Prec,
                 per_graph: bool = True, drops=None) -> torch.Tensor:
    """[n_graphs, out_dim] logits. `drops`: one keep-mask [N, hidden] per
    layer (training), or None (evaluation)."""
    p = w["params"]
    t = int(gnn["n_node_types"])
    hid = int(gnn["hidden_dim"])
    n_h = int(gnn["n_heads"])
    dk = hid // n_h
    rate = float(gnn.get("feat_drop", 0.0))
    n = g.feat.shape[0]
    src_t, dst_t = g.ntype[g.src], g.ntype[g.dst]
    # relation (esign, source type) into each destination type
    rel = (g.esign * t + src_t) * t + dst_t
    present, type_present = _presence(g, t, 2 * t * t, rel, per_graph)
    dst_denom = present.reshape(-1, 2 * t, t).sum(1).float()     # [G', T]
    grow = g.graph if per_graph else torch.zeros_like(g.graph)
    denom_node = dst_denom[grow, g.ntype]                        # [N]
    has_update = (denom_node > 0) & g.mask
    seg = g.dst * (2 * t) + g.esign * t + src_t
    h = typed_linear(prec, g.feat, g.ntype, p["adapt_ws"], t)
    for i in range(int(gnn["num_layers"])):
        lp = p[f"gcs_{i}"]
        k = typed_linear(prec, h, g.ntype, lp["k_linears"], t).reshape(n, n_h, dk)
        q = typed_linear(prec, h, g.ntype, lp["q_linears"], t).reshape(n, n_h, dk)
        v = typed_linear(prec, h, g.ntype, lp["v_linears"], t).reshape(n, n_h, dk)
        ea = g.sim * lp["e_linear"]["kernel"][0, 0] + lp["e_linear"]["bias"][0]
        score = (q[g.dst] * k[g.src]).sum(-1) * ea[:, None] / math.sqrt(dk)
        live = g.emask
        with torch.no_grad():
            hot = torch.where(live[:, None], score.abs(), 0.0).amax()
            dmax = torch.full((n,), -math.inf, device=score.device)
            dmax = dmax.index_reduce(0, g.dst[live], score[live].amax(-1), "amax")
            dmax = torch.where(torch.isfinite(dmax), dmax, 0.0)
        score = torch.where(hot > 0.9 * CLAMP, score - dmax[g.dst][:, None], score)
        attn = segment_softmax(score.clamp(-CLAMP, CLAMP), seg, n * 2 * t, live)
        msg = (attn[..., None] * v[g.src]).reshape(-1, hid)
        agg = h.new_zeros(n, hid).index_add(0, g.dst, msg)
        trans = typed_linear(prec, agg / denom_node.clamp_min(1.0)[:, None],
                             g.ntype, lp["a_linears"], t)
        trans = _dropout(trans, None if drops is None else drops[i], rate)
        alpha = torch.sigmoid(lp["skip"])[g.ntype][:, None]
        h = torch.where(has_update[:, None], trans * alpha + h * (1 - alpha), h)
    pooled = type_mean(h, g, t)                                   # [G, T, hid]
    pres = type_present.float()
    if not per_graph:
        pres = pres.expand(g.n_graphs, t)
    lp = p["linears_prediction"]
    out_h = (prec.einsum("btd,tdo->bto", pooled, lp["kernel"]) + lp["bias"]
             ) * pres[:, :, None]
    hg = out_h.sum(1)
    gated = []
    for kk in range(t):
        c = prec.mm(out_h[:, kk] + hg, p[f"attn_{kk}"]["op"]["kernel"])
        a = torch.softmax(c[:, :, None], dim=2)[:, :, 0]
        gated.append(a * out_h[:, kk] * pres[:, kk:kk + 1])
    x = linear(prec, torch.cat(gated, dim=1), p["head_2"])
    return linear(prec, linear(prec, x, p["head_1"]), p["head"])


# ---------------------------------------------------------------------------
# HGT
# ---------------------------------------------------------------------------
def _layer_norm(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def hgt_logits(w: Dict, g: Graph, gnn: Dict, prec: Prec,
               per_graph: bool = True, drops=None, rate: float = 0.2
               ) -> torch.Tensor:
    """[n_graphs, out_dim] logits. The HGT layers' dropout is 0.2 (the
    layer's default: the reference model never passes feat_drop)."""
    p = w["params"]
    t = int(gnn["n_node_types"])
    hid = int(gnn["hidden_dim"])
    n_h = int(gnn["num_heads"])
    dk = hid // n_h
    e_t = 2
    n = g.feat.shape[0]
    src_t, dst_t = g.ntype[g.src], g.ntype[g.dst]
    rel = g.esign * t * t + src_t * t + dst_t
    present, type_present = _presence(g, t, e_t * t * t, rel, per_graph)
    dst_denom = (present.reshape(-1, e_t, t, t).sum((1, 2))).float()
    grow = g.graph if per_graph else torch.zeros_like(g.graph)
    denom_node = dst_denom[grow, g.ntype]
    has_update = (denom_node > 0) & g.mask
    pres = type_present.float()
    if not per_graph:
        pres = pres.expand(g.n_graphs, t)
    seg = g.dst * (e_t * t * t) + rel
    h = F.gelu(typed_linear(prec, g.feat, g.ntype, p["adapt_ws"], t))
    hg = g.feat.new_zeros(g.n_graphs, int(gnn["out_dim"]))
    for i in range(int(gnn["num_layers"])):
        hp = p[f"pred_{i}"]
        heads = prec.einsum("btd,tdo->bto", type_mean(h, g, t), hp["kernel"]) + hp["bias"]
        hg = hg + (heads * pres[:, :, None]).sum(1)
        lp = p[f"gcs_{i}"]
        k = typed_linear(prec, h, g.ntype, lp["k_linears"], t).reshape(n, n_h, dk)
        q = typed_linear(prec, h, g.ntype, lp["q_linears"], t).reshape(n, n_h, dk)
        v = typed_linear(prec, h, g.ntype, lp["v_linears"], t).reshape(n, n_h, dk)
        a_r = lp["relation_att"].reshape(e_t, t, t, n_h, dk, dk)
        m_r = lp["relation_msg"].reshape(e_t, t, t, n_h, dk, dk)
        # each node's K and V under every (sign, destination type) its
        # source type can take: [N, 2, T, H, dk]
        k_c = k.new_zeros(n, e_t, t, n_h, dk)
        v_c = v.new_zeros(n, e_t, t, n_h, dk)
        for s in range(t):
            rows = (g.ntype == s).nonzero()[:, 0]
            if rows.numel():
                k_c = k_c.index_copy(0, rows, prec.einsum(
                    "nhd,zthde->nzthe", k[rows], a_r[:, s]))
                v_c = v_c.index_copy(0, rows, prec.einsum(
                    "nhd,zthde->nzthe", v[rows], m_r[:, s]))
        k_e = k_c[g.src, g.esign, dst_t]
        v_e = v_c[g.src, g.esign, dst_t]
        pri = lp["relation_pri"][rel]
        score = (q[g.dst] * k_e).sum(-1) * pri / math.sqrt(dk)
        attn = segment_softmax(score, seg, n * e_t * t * t, g.emask)
        agg = h.new_zeros(n, hid).index_add(
            0, g.dst, (v_e * attn[..., None]).reshape(-1, hid))
        trans = typed_linear(prec, agg / denom_node.clamp_min(1.0)[:, None],
                             g.ntype, lp["a_linears"], t)
        trans = _dropout(trans, None if drops is None else drops[i], rate)
        alpha = torch.sigmoid(lp["skip"])[g.ntype][:, None]
        out = torch.where(has_update[:, None], trans * alpha + h * (1 - alpha), h)
        normed = _layer_norm(out, lp["norms"]["scale"][g.ntype],
                             lp["norms"]["bias"][g.ntype])
        h = torch.where(has_update[:, None], normed, out)
    return hg
