"""H2MIL, hierarchical heterogeneous-graph MIL over multi-resolution trees
(counterpart of wsi_hgnn_tpu/models/mil/h2mil.py).

  * `RAConvLayer`: the reference's two-level attention. Per-edge GAT
    logits are softmaxed within each (dst node, source resolution type)
    group, scaled by a resolution-level attention over the per-(dst, src
    type) mean aggregates, and summed into the destination.
  * `IHPool`: pooling with fixed cluster budgets. Centres are evenly
    spaced fitness order statistics (tanh(x.w/|w|)), level-2 centres
    chosen per parent cluster (k2 // k1 each); every node goes to its
    nearest (x, y, fitness) centre, a +1e6 penalty keeping level-2 nodes
    inside their parent's cluster; features and coordinates pool by
    segment mean, edges are relabelled (A' = S^T A S). Padding clusters
    are masked out. The pool weights reach the output only through sorts
    and argmins, so autograd gives them no gradient (`fill_dead_grads`).
  * `H2MIL`: RAConv -> pool -> masked mean readout, twice, summed, then a
    2-layer classifier. LayerNorms use flax's epsilon, 1e-6.

Inputs are the flat arrays of the reference's PyG Data, as a `TreeGraph`:
feats [N, D], (src, dst) tree-adjacency edges, node_type [N] in {0, 1, 2}
(resolution level), tree [N] (parent index), xy [N, 2], and masks.

Two host builders give numpy TreeGraphs (`tree_to_torch` moves one to a
device): `build_tree_graph_levels` from real two-magnification nested
bags (`scan_nested_bag` reads one), `build_tree_graph` with the parent
level synthesised from single-magnification features.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...graph.ops import segment_softmax, segment_sum
from ...graph.typed_graph import bucket_size
from .simclr import spatial_adjacency

_N_RES = 3  # resolution levels {thumbnail 0, low 1, high 2}
LN_EPS = 1e-6  # flax nn.LayerNorm's default


class TreeGraph(NamedTuple):
    feats: object      # [N, D]
    src: object        # [E]
    dst: object        # [E]
    node_type: object  # [N] resolution level
    tree: object       # [N] parent node index (thumbnail -> itself)
    xy: object         # [N, 2]
    node_mask: object  # [N]
    edge_mask: object  # [E]


def tree_to_torch(t: TreeGraph, device, dtype=torch.float32) -> TreeGraph:
    """A numpy TreeGraph as tensors on `device`: floats in `dtype`,
    indices int64, masks bool."""
    def conv(name, a):
        a = torch.from_numpy(np.asarray(a))
        if name in ("feats", "xy"):
            return a.to(device, dtype)
        if name in ("node_mask", "edge_mask"):
            return a.to(device, torch.bool)
        return a.to(device, torch.int64)
    return TreeGraph(*(conv(n, a) for n, a in zip(TreeGraph._fields, t)))


def _pad(x, cap, fill=0):
    out = np.full((cap,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _finish(all_feats, src, dst, node_type, tree, all_xy, n,
            node_capacity, edge_capacity, bucket_base) -> TreeGraph:
    e = len(src)
    cap_n = node_capacity or bucket_size(n, base=bucket_base)
    cap_e = edge_capacity or bucket_size(e, base=bucket_base)
    if cap_n < n or cap_e < e:
        raise ValueError(f"tree capacity too small: {n}>{cap_n} or {e}>{cap_e}")
    return TreeGraph(
        feats=_pad(all_feats, cap_n),
        src=_pad(src, cap_e),
        dst=_pad(dst, cap_e),
        node_type=_pad(node_type, cap_n),
        tree=_pad(tree, cap_n),
        xy=_pad(all_xy.astype(np.float32), cap_n),
        node_mask=np.arange(cap_n) < n,
        edge_mask=np.arange(cap_e) < e,
    )


def build_tree_graph(feats, coords, cell: int = 4,
                     node_capacity: Optional[int] = None,
                     edge_capacity: Optional[int] = None,
                     bucket_base: int = 256) -> TreeGraph:
    """The H2MIL tree from ONE magnification level: the low-resolution
    level is synthesised by grouping patches into `cell` x `cell` tile
    blocks whose features are the block means.

    Node 0 is the root (global mean, type 0), then one type-1 node per
    occupied block, then the type-2 patches. Edges: root<->level-1,
    parent<->child and 8-neighbour adjacency within each level, both
    directions. Coordinates are scaled to [-1, 1] per axis."""
    feats = np.asarray(feats, np.float32)
    coords = np.asarray(coords, np.int64)
    n2, d = feats.shape

    block = [tuple(c // cell) for c in coords]
    blocks = sorted(set(block))
    bidx = {b: i for i, b in enumerate(blocks)}
    n1 = len(blocks)
    parent1 = np.asarray([bidx[b] for b in block], np.int32)  # patch -> block

    f1 = np.zeros((n1, d), np.float32)
    np.add.at(f1, parent1, feats)
    cnt = np.bincount(parent1, minlength=n1).astype(np.float32)
    f1 /= np.maximum(cnt, 1.0)[:, None]
    xy1 = np.zeros((n1, 2), np.float64)
    np.add.at(xy1, parent1, coords.astype(np.float64))
    xy1 /= np.maximum(cnt, 1.0)[:, None]

    root_feat = feats.mean(0, keepdims=True)
    root_xy = coords.astype(np.float64).mean(0, keepdims=True)

    off1, off2 = 1, 1 + n1
    n = off2 + n2
    all_feats = np.concatenate([root_feat, f1, feats], 0)
    all_xy = np.concatenate([root_xy, xy1, coords.astype(np.float64)], 0)
    # [-1, 1] per axis: IHPool adds spatial distance to a tanh fitness
    lo, hi = all_xy.min(0), all_xy.max(0)
    span = np.maximum(hi - lo, 1e-12)
    all_xy = (all_xy - lo) / span * 2.0 - 1.0
    node_type = np.concatenate(
        [np.zeros(1, np.int32), np.ones(n1, np.int32), np.full(n2, 2, np.int32)])
    tree = np.concatenate(
        [np.zeros(1, np.int32), np.zeros(n1, np.int32), off1 + parent1])

    src2, dst2 = spatial_adjacency([tuple(c) for c in coords])
    src1, dst1 = spatial_adjacency(blocks)
    srcs = [off2 + src2, off1 + src1]
    dsts = [off2 + dst2, off1 + dst1]
    child = np.arange(n2, dtype=np.int32) + off2
    srcs += [child, tree[child], off1 + np.arange(n1, dtype=np.int32),
             np.zeros(n1, np.int32)]
    dsts += [tree[child], child, np.zeros(n1, np.int32),
             off1 + np.arange(n1, dtype=np.int32)]
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    return _finish(all_feats, src, dst, node_type, tree, all_xy, n,
                   node_capacity, edge_capacity, bucket_base)


def scan_nested_bag(bag_dir, ext: str = "jpeg"):
    """Scan one 2-level nested bag directory (pipeline.tiler.nested_patches
    layout: low-mag tiles `{x}_{y}.{ext}` at the root, each with an
    optional child directory `{x}_{y}/` of high-mag tiles) and the
    optional thumbnail `-1.{ext}` (or `thumbnail.{ext}`).

    Returns (low_paths, low_xy [n1, 2] int, high_paths, high_xy [n2, 2]
    int, parent [n2] index into low_paths, thumb_path | None). Childless
    low tiles are kept."""
    bag = Path(bag_dir)
    thumb = None
    low = []
    for p in sorted(bag.glob(f"*.{ext}")):
        stem = p.name.rsplit(".", 1)[0]
        if stem in ("-1", "thumbnail"):
            thumb = p
            continue
        x, y = stem.split("_")[:2]
        low.append((p, int(x), int(y)))
    if not low:
        raise FileNotFoundError(f"no low-magnification tiles under {bag}")
    high, parent = [], []
    for i, (p, x, y) in enumerate(low):
        child_dir = bag / f"{x}_{y}"
        if not child_dir.is_dir():
            continue
        for hp in sorted(child_dir.glob(f"*.{ext}")):
            hx, hy = hp.name.rsplit(".", 1)[0].split("_")[:2]
            high.append((hp, int(hx), int(hy)))
            parent.append(i)
    low_paths = [p for p, _, _ in low]
    low_xy = np.asarray([(x, y) for _, x, y in low], np.int64).reshape(-1, 2)
    high_paths = [p for p, _, _ in high]
    high_xy = np.asarray([(x, y) for _, x, y in high], np.int64).reshape(-1, 2)
    return (low_paths, low_xy, high_paths, high_xy,
            np.asarray(parent, np.int32), thumb)


def build_tree_graph_levels(feats1, xy1, feats2, xy2, parent, thumb_feat=None,
                            node_capacity: Optional[int] = None,
                            edge_capacity: Optional[int] = None,
                            bucket_base: int = 256) -> TreeGraph:
    """The H2MIL tree from real two-magnification features: node 0 the
    slide thumbnail, level 1 the low-magnification tiles, level 2 the
    high-magnification tiles under their level-1 parents.

    Edges: thumbnail <-> every level-1 node, level-1 <-> each of its
    level-2 children, 8-neighbour grid adjacency within each level, all
    both directions. tree: level-1 -> thumbnail, level-2 -> its parent,
    the thumbnail to itself. xy: per-level grid coordinates over that
    level's max, then * 2 - 1; the thumbnail at (-1, -1). Without
    `thumb_feat` the level-1 feature mean stands in for the thumbnail."""
    feats1 = np.asarray(feats1, np.float32)
    feats2 = np.asarray(feats2, np.float32)
    xy1 = np.asarray(xy1, np.int64).reshape(-1, 2)
    xy2 = np.asarray(xy2, np.int64).reshape(-1, 2)
    parent = np.asarray(parent, np.int32)
    n1, d = feats1.shape
    n2 = feats2.shape[0]
    if n2 != len(parent):
        raise ValueError(f"{n2} level-2 nodes but {len(parent)} parents")
    if n2 and (parent.min() < 0 or parent.max() >= n1):
        raise ValueError("parent indices out of the level-1 range")

    root_feat = (feats1.mean(0, keepdims=True) if thumb_feat is None
                 else np.asarray(thumb_feat, np.float32).reshape(1, d))

    def norm(xy):
        mx = np.maximum(xy.max(0), 1) if len(xy) else np.ones(2)
        return xy.astype(np.float64) / mx * 2.0 - 1.0

    all_xy = np.concatenate([np.full((1, 2), -1.0), norm(xy1), norm(xy2)], 0)

    off1, off2 = 1, 1 + n1
    n = off2 + n2
    all_feats = np.concatenate([root_feat, feats1, feats2], 0)
    node_type = np.concatenate(
        [np.zeros(1, np.int32), np.ones(n1, np.int32), np.full(n2, 2, np.int32)])
    tree = np.concatenate(
        [np.zeros(1, np.int32), np.zeros(n1, np.int32), off1 + parent])

    src1, dst1 = spatial_adjacency([tuple(c) for c in xy1])
    src2, dst2 = spatial_adjacency([tuple(c) for c in xy2])
    l1 = off1 + np.arange(n1, dtype=np.int32)
    child = off2 + np.arange(n2, dtype=np.int32)
    srcs = [off1 + src1, off2 + src2, l1, np.zeros(n1, np.int32),
            child, tree[child]]
    dsts = [off1 + dst1, off2 + dst2, np.zeros(n1, np.int32), l1,
            tree[child], child]
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    return _finish(all_feats, src, dst, node_type, tree, all_xy, n,
                   node_capacity, edge_capacity, bucket_base)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class RAConvLayer(nn.Module):
    """Resolution-aware attention convolution: forward(g, x [N, in_dim])
    -> [N, heads * features]."""

    def __init__(self, in_dim: int, features: int, heads: int = 1,
                 negative_slope: float = 0.2):
        super().__init__()
        self.heads, self.features = heads, features
        self.negative_slope = negative_slope
        hc = heads * features
        self.lin_l = nn.Linear(in_dim, hc, bias=False)
        self.t_lin_l = nn.Linear(in_dim, hc, bias=False)
        for name in ("att_l", "att_r", "t_att_l", "t_att_r"):
            self.register_parameter(name, nn.Parameter(nn.init.xavier_uniform_(
                torch.empty(1, heads, features))))
        self.bias = nn.Parameter(torch.zeros(hc))

    def forward(self, g: TreeGraph, x: torch.Tensor) -> torch.Tensor:
        h, c = self.heads, self.features
        n = x.shape[0]
        slope = self.negative_slope
        xl = self.lin_l(x).reshape(n, h, c)
        alpha_l = (xl * self.att_l).sum(-1)     # [N, H]
        alpha_r = (xl * self.att_r).sum(-1)

        # node-level attention grouped by (dst, src resolution type)
        group = g.dst * _N_RES + g.node_type.index_select(0, g.src)
        logits = F.leaky_relu(alpha_l.index_select(0, g.src)
                              + alpha_r.index_select(0, g.dst), slope)
        alpha = segment_softmax(logits, group, n * _N_RES, mask=g.edge_mask)

        # resolution-level aggregates: mean of raw x per (dst, src type)
        ew = g.edge_mask.to(x.dtype)
        t_sum = segment_sum(x.index_select(0, g.src) * ew[:, None], group,
                            n * _N_RES)
        t_cnt = segment_sum(ew, group, n * _N_RES)
        t_x = t_sum / t_cnt.clamp_min(1.0)[:, None]       # [N*3, D]

        t_src = self.t_lin_l(t_x).reshape(n * _N_RES, h, c)
        t_dst = self.t_lin_l(x).reshape(n, h, c)
        t_logits = F.leaky_relu(
            (t_src * self.t_att_l).sum(-1)
            + torch.repeat_interleave((t_dst * self.t_att_r).sum(-1), _N_RES,
                                      dim=0), slope)      # [N*3, H]
        group_nodes = torch.repeat_interleave(
            torch.arange(n, device=x.device), _N_RES)
        t_alpha = segment_softmax(t_logits, group_nodes, n, mask=t_cnt > 0)

        coeff = alpha * t_alpha.index_select(0, group)    # [E, H]
        msgs = xl.index_select(0, g.src) * coeff[:, :, None]
        msgs = torch.where(g.edge_mask[:, None, None], msgs, 0.0)
        out = segment_sum(msgs, g.dst, n).reshape(n, h * c)
        return out + self.bias


class IHPool(nn.Module):
    """Fixed-budget iterative hierarchical pooling: k1 level-1 clusters,
    k2 level-2 clusters; the output graph has 1 + k1 + k2 node slots.
    forward(g, x [N, dim]) -> (pooled TreeGraph, pooled x)."""

    def __init__(self, dim: int, k1: int = 8, k2: int = 32):
        super().__init__()
        self.k1, self.k2 = k1, k2
        self.weight_1 = nn.Parameter(torch.rand(1, dim))
        self.weight_2 = nn.Parameter(torch.rand(1, dim))

    def forward(self, g: TreeGraph, x: torch.Tensor):
        n = x.shape[0]
        dev = x.device
        k1, k2 = self.k1, self.k2

        def fitness(w, level):
            f = torch.tanh((x * w).sum(-1)
                           / torch.linalg.norm(w).clamp_min(1e-12))
            return f, g.node_mask & (g.node_type == level)

        def centers(f, valid, k):
            """Evenly spaced fitness order statistics; invalid nodes sort
            last (+inf); with fewer valid nodes than k, the prefix."""
            order = torch.argsort(torch.where(valid, f, torch.inf),
                                  stable=True)
            n_valid = valid.sum()
            nv = n_valid.clamp_min(1)
            ar = torch.arange(k, device=dev)
            even = torch.div(ar * nv, k, rounding_mode="floor")
            prefix = torch.minimum(ar, nv - 1)
            pos = torch.where(nv >= k, even, prefix).clamp(0, n - 1)
            return order[pos], ar < torch.clamp(n_valid, max=k)

        f1, v1 = fitness(self.weight_1, 1)
        c1_idx, c1_ok = centers(f1, v1, k1)
        f2, v2 = fitness(self.weight_2, 2)

        def assign(f, c_idx, c_ok, parent_cluster=None, center_parent=None):
            """Nearest (x, y, fitness) centre, spatial distance plus the
            fitness difference; a +1e6 penalty outside the parent."""
            p = torch.cat([g.xy, f[:, None]], -1)          # [N, 3]
            cp = p[c_idx]                                  # [K, 3]
            d_xy = torch.sqrt(((p[:, None, :2] - cp[None, :, :2]) ** 2
                               ).sum(-1).clamp_min(1e-12))
            d_f = (p[:, None, 2] - cp[None, :, 2]).abs()
            dist = torch.where(c_ok[None, :], d_xy + d_f, torch.inf)
            if parent_cluster is not None:
                same = parent_cluster[:, None] == center_parent[None, :]
                dist = torch.where(same, dist, dist + 1e6)
            return torch.argmin(dist, dim=1)

        a1 = assign(f1, c1_idx, c1_ok)                     # [N] in [0, k1)
        # level-2 centres per parent cluster: q = k2 // k1 evenly spaced
        # fitness order statistics within the parent's run of one
        # (parent, fitness)-sorted order; f2 lies in (-1, 1), so a stride-4
        # parent offset keeps the runs disjoint
        parent_c1 = torch.where(v2, a1[g.tree], k1)
        q = max(k2 // k1, 1)
        key2 = torch.where(v2, parent_c1.to(x.dtype) * 4.0 + f2, torch.inf)
        order2 = torch.argsort(key2, stable=True)
        cnt_p = segment_sum(v2.to(torch.int64), parent_c1, k1 + 1)[:k1]
        start_p = (torch.cumsum(cnt_p, 0) - cnt_p)[:, None]   # [k1, 1]
        s = torch.arange(q, device=dev)[None, :]
        nv = cnt_p.clamp_min(1)[:, None]
        even = torch.div(s * nv, q, rounding_mode="floor")
        prefix = torch.minimum(s, nv - 1)
        pos = start_p + torch.where(nv >= q, even, prefix)    # [k1, q]
        c2_idx = order2[pos.clamp(0, n - 1).reshape(-1)]
        c2_ok = (s < cnt_p[:, None]).reshape(-1)
        center_parent = torch.repeat_interleave(
            torch.arange(k1, device=dev), q)
        a2 = assign(f2, c2_idx, c2_ok, parent_c1, center_parent)

        # global cluster id: 0 thumbnail, 1..k1 level 1, k1+1.. level 2
        cluster = torch.where(g.node_type == 0, 0, torch.where(
            g.node_type == 1, 1 + a1, 1 + k1 + a2))
        cluster = torch.where(g.node_mask, cluster, 0)
        k_out = 1 + k1 + k2

        m = g.node_mask.to(x.dtype)
        cnts = segment_sum(m, cluster, k_out)
        new_x = (segment_sum(x * m[:, None], cluster, k_out)
                 / cnts.clamp_min(1.0)[:, None])
        new_xy = (segment_sum(g.xy * m[:, None], cluster, k_out)
                  / cnts.clamp_min(1.0)[:, None])

        i64 = dict(dtype=torch.int64, device=dev)
        new_type = torch.cat([torch.zeros(1, **i64), torch.ones(k1, **i64),
                              torch.full((k2,), 2, **i64)])
        # level-2 slots: the first k1*q map to their parent cluster; the
        # k2 - k1*q remainder are never assigned (cnts == 0, masked out)
        new_tree = torch.cat([torch.zeros(1 + k1, **i64), 1 + center_parent,
                              torch.zeros(k2 - center_parent.shape[0], **i64)])
        new_mask = cnts > 0
        new_src = cluster[g.src]
        new_dst = cluster[g.dst]
        new_emask = g.edge_mask & new_mask[new_src] & new_mask[new_dst]
        return TreeGraph(new_x, new_src, new_dst, new_type, new_tree, new_xy,
                         new_mask, new_emask), new_x


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scaled by
    1 / (1 - rate), the mask drawn from `generator` (on x's device)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class H2MIL(nn.Module):
    """The H2MIL classifier head: forward(g, generator=None) -> logits
    [1, n_classes]; dropout is live in training mode, its masks drawn from
    `generator`."""

    def __init__(self, in_dim: int, hidden_dim: int, n_classes: int,
                 k1: int = 8, k2: int = 32, dropout: float = 0.2):
        super().__init__()
        self.norm0 = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.conv1 = RAConvLayer(in_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.pool_1 = IHPool(hidden_dim, k1, k2)
        self.conv2 = RAConvLayer(hidden_dim, hidden_dim)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.pool_2 = IHPool(hidden_dim, max(k1 // 2, 1), max(k2 // 2, 1))
        self.lin1 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.lin2 = nn.Linear(hidden_dim // 2, n_classes)
        self.rate = dropout

    def forward(self, g: TreeGraph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(x):
            return dropout(x, self.rate, self.training, generator)

        x = self.norm0(g.feats)
        x = drop(self.norm1(F.relu(self.conv1(g, x))))
        g1, x = self.pool_1(g, x)
        m1 = g1.node_mask.to(x.dtype)[:, None]
        x1 = (x * m1).sum(0) / m1.sum().clamp_min(1.0)

        x = drop(self.norm2(F.relu(self.conv2(g1, x))))
        g2, x = self.pool_2(g1, x)
        m2 = g2.node_mask.to(x.dtype)[:, None]
        x2 = (x * m2).sum(0) / m2.sum().clamp_min(1.0)

        z = drop(F.relu(self.lin1(x1 + x2)))
        return self.lin2(z)[None, :]


def fill_dead_grads(module: nn.Module) -> None:
    """Zero gradients for the parameters autograd never reached (IHPool's
    weights), so the optimizer's coupled L2 still moves them, as JAX's
    zero gradient plus add_decayed_weights does."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
