"""The first training steps, plain: the batches a seeded shuffle gives,
the augmentation and dropout a seeded generator draws, the weighted
cross-entropy, autograd's gradients and Adam with coupled L2 weight
decay (torch.optim.Adam's rule, as the reference repository trains).

What the reference repository's training fixes, and this follows:
  * the epoch order: np.random.RandomState(seed).shuffle over the train
    list, batches of batch_size in that order;
  * each step's random draws, in this order from one torch.Generator on
    the device seeded with the same seed: DropNode keep [nodes], DropEdge
    keep [edges], FeatMask keep [feature columns] (keep probability 0.5
    each, u < 0.5 for u uniform), then one dropout keep-mask per GNN layer
    [nodes, hidden] (u < 1 - rate), where the node and edge slots are the
    batch's padded layout: HEAT4 trains on a [B, cap, k] lattice (node
    capacity cap = the cohort's size bucket, the j-th neighbour of node i
    at slot (i, j)); HGT on one flat graph padded to bucketed node and
    edge capacities, edges ordered by (destination, sign, source type);
  * DropNode clears a node and its edges, DropEdge clears edges,
    FeatMask zeroes columns; occupancy is counted over the batch.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .gnn import Graph, heat4_logits, hgt_logits
from .precision import Prec
from .weights import leaves

AUG_P = 0.5


def bucket_size(n: int, base: int = 256) -> int:
    """Next capacity >= n in {base, 1.5 base, 2 base, 3 base, 4 base, ...}."""
    n = max(int(n), 1)
    cap = base
    while cap < n:
        if cap + cap // 2 >= n:
            return cap + cap // 2
        cap *= 2
    return cap


def read_slide(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in ("feat", "src", "dst",
                                               "node_type", "esign", "sim")}


def epoch_batches(n_slides: int, batch_size: int, rng: np.random.RandomState
                  ) -> List[List[int]]:
    order = np.arange(n_slides)
    rng.shuffle(order)
    return [list(order[i:i + batch_size]) for i in range(0, n_slides, batch_size)]


def _rand_keep(shape, keep: float, gen: torch.Generator):
    return torch.rand(shape, generator=gen, device=gen.device) < keep


def lattice_batch(slides: Sequence[Dict], cap: int, k: int, dev) -> Dict:
    """[B, cap, ...] buffers: slot (i, j) holds node i's j-th out-edge."""
    b = len(slides)
    d = slides[0]["feat"].shape[1]
    feat = np.zeros((b, cap, d), np.float32)
    ntype = np.zeros((b, cap), np.int64)
    mask = np.zeros((b, cap), bool)
    idx = np.zeros((b, cap, k), np.int64)
    sim = np.zeros((b, cap, k), np.float32)
    esign = np.zeros((b, cap, k), np.int64)
    emask = np.zeros((b, cap, k), bool)
    for s, sl in enumerate(slides):
        n = sl["feat"].shape[0]
        src = sl["src"].astype(np.int64)
        order = np.argsort(src, kind="stable")
        srt = src[order]
        slot = np.arange(len(srt)) - np.searchsorted(srt, srt, side="left")
        feat[s, :n] = sl["feat"]
        ntype[s, :n] = sl["node_type"]
        mask[s, :n] = True
        idx[s, srt, slot] = sl["dst"][order]
        sim[s, srt, slot] = sl["sim"][order]
        esign[s, srt, slot] = sl["esign"][order]
        emask[s, srt, slot] = True
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(feat=t(feat), ntype=t(ntype), mask=t(mask), idx=t(idx),
                sim=t(sim), esign=t(esign), emask=t(emask))


def lattice_graph(lat: Dict, gen: torch.Generator, hidden: int,
                  n_layers: int, rate: float):
    """The augmented flat Graph of a lattice batch, and the layers'
    dropout keep-masks, drawn in the trainer's order."""
    b, cap, k = lat["idx"].shape
    d = lat["feat"].shape[-1]
    keep_node = _rand_keep((b, cap), 1 - AUG_P, gen)
    keep_edge = _rand_keep((b, cap, k), 1 - AUG_P, gen)
    keep_col = _rand_keep((d,), 1 - AUG_P, gen)
    drops = [_rand_keep((b * cap, hidden), 1 - rate, gen)
             for _ in range(n_layers)] if rate > 0 else None
    dev = lat["idx"].device
    base = (torch.arange(b, device=dev) * cap)[:, None, None]
    src = (torch.arange(cap, device=dev)[None, :, None] + base).expand(b, cap, k)
    dst = lat["idx"] + base
    kn = keep_node.reshape(-1)
    src, dst = src.reshape(-1), dst.reshape(-1)
    emask = (lat["emask"].reshape(-1) & kn[src] & kn[dst]
             & (keep_edge.reshape(-1) | (src == dst)))
    g = Graph(feat=(lat["feat"] * keep_col.float()).reshape(b * cap, d),
              ntype=lat["ntype"].reshape(-1),
              graph=torch.arange(b, device=dev).repeat_interleave(cap),
              mask=lat["mask"].reshape(-1) & kn, src=src, dst=dst,
              esign=lat["esign"].reshape(-1), sim=lat["sim"].reshape(-1),
              emask=emask, n_graphs=b)
    return g, drops


def flat_graph(slides: Sequence[Dict], cap_n: int, cap_e: int, t: int,
               gen: torch.Generator, hidden: int, n_layers: int, rate: float,
               dev):
    """The augmented flat Graph of a batch padded to (cap_n, cap_e), edges
    in (destination, sign, source type) order, and the dropout masks."""
    feats, ntypes, graphs, srcs, dsts, esigns, sims = [], [], [], [], [], [], []
    off = 0
    for s, sl in enumerate(slides):
        n = sl["feat"].shape[0]
        feats.append(sl["feat"])
        ntypes.append(sl["node_type"].astype(np.int64))
        graphs.append(np.full(n, s, np.int64))
        srcs.append(sl["src"].astype(np.int64) + off)
        dsts.append(sl["dst"].astype(np.int64) + off)
        esigns.append(sl["esign"].astype(np.int64))
        sims.append(sl["sim"].astype(np.float32))
        off += n
    n_real, ntype = off, np.concatenate(ntypes)
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    esign, sim = np.concatenate(esigns), np.concatenate(sims)
    order = np.argsort(dst * (2 * t) + esign * t + ntype[src], kind="stable")
    e_real = len(src)
    d = feats[0].shape[1]
    feat = np.zeros((cap_n, d), np.float32)
    feat[:n_real] = np.concatenate(feats)
    nt = np.zeros(cap_n, np.int64)
    nt[:n_real] = ntype
    gr = np.zeros(cap_n, np.int64)
    gr[:n_real] = np.concatenate(graphs)
    keep_node = _rand_keep((cap_n,), 1 - AUG_P, gen)
    keep_edge = _rand_keep((cap_e,), 1 - AUG_P, gen)[:e_real]
    keep_col = _rand_keep((d,), 1 - AUG_P, gen)
    drops = [_rand_keep((cap_n, hidden), 1 - rate, gen)
             for _ in range(n_layers)] if rate > 0 else None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    src_t, dst_t = T(src[order]), T(dst[order])
    mask = T(np.arange(cap_n) < n_real) & keep_node
    emask = keep_node[src_t] & keep_node[dst_t] & keep_edge
    g = Graph(feat=T(feat) * keep_col.float(), ntype=T(nt), graph=T(gr),
              mask=mask, src=src_t, dst=dst_t, esign=T(esign[order]),
              sim=T(sim[order]), emask=emask, n_graphs=len(slides))
    return g, drops


def weighted_ce(logits, labels, weights):
    nll = -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    return (nll * weights).sum() / weights.sum().clamp_min(1.0)


def _unflatten(names, values) -> Dict:
    tree: Dict = {}
    for name, v in zip(names, values):
        node = tree
        keys = name.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return tree


def reference_steps(model: str, weights: Dict, gnn: Dict, optim: Dict,
                    paths: Sequence[str], labels: Sequence[int],
                    batch_size: int, seed: int, n_steps: int, prec: Prec,
                    dev, half_batch: bool = False) -> Dict:
    """Run the first `n_steps` steps from `weights` (flax-layout device
    tensors). Returns per-step losses, the leaves' first raw gradients
    and first Adam inputs (gradient + weight decay * parameter), and the
    parameters after the last step, each {path: tensor}.
    `half_batch` plants a fault for calibration: the loss is the mean
    over the first half of each batch only."""
    names, p0 = zip(*[(n, v) for n, v in leaves(weights) if n.startswith("params/")])
    params = [v.detach().clone().requires_grad_(True) for v in p0]
    lr, wd = float(optim["lr"]), float(optim.get("weight_decay", 0.0))
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [torch.zeros_like(v) for v in params]
    v2 = [torch.zeros_like(v) for v in params]
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    slides = [read_slide(p) for p in paths]
    t = int(gnn["n_node_types"])
    max_n = max(s["feat"].shape[0] for s in slides)
    max_e = max(len(s["src"]) for s in slides)
    k = max(int(np.bincount(s["src"]).max()) for s in slides)
    batches: List[List[int]] = []
    losses, grad1, adam1 = [], {}, {}
    for step in range(n_steps):
        if not batches:
            batches = epoch_batches(len(slides), batch_size, rng)
        idxs = batches.pop(0)
        sl = [slides[i] for i in idxs]
        lab = [int(labels[i]) for i in idxs]
        wts = [1.0] * len(sl)
        while len(sl) < batch_size:
            sl.append(sl[0])
            lab.append(0)
            wts.append(0.0)
        w = _unflatten(names, params)
        if model == "heat4":
            g, drops = lattice_graph(
                lattice_batch(sl, bucket_size(max_n), k, dev), gen,
                int(gnn["hidden_dim"]), int(gnn["num_layers"]),
                float(gnn.get("feat_drop", 0.0)))
            logits = heat4_logits({"params": w["params"]}, g, gnn, prec,
                                  per_graph=False, drops=drops)
        else:
            g, drops = flat_graph(
                sl, bucket_size(max_n * batch_size, 1024),
                bucket_size(max_e * batch_size, 1024), t, gen,
                int(gnn["hidden_dim"]), int(gnn["num_layers"]), 0.2, dev)
            logits = hgt_logits({"params": w["params"]}, g, gnn, prec,
                                per_graph=False, drops=drops)
        y = torch.tensor(lab, device=dev)
        wt = torch.tensor(wts, device=dev)
        if half_batch:
            keep = max(1, len(sl) // 2)
            logits, y, wt = logits[:keep], y[:keep], wt[:keep]
        loss = weighted_ce(logits, y, wt)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for i, (p, g_) in enumerate(zip(params, grads)):
                g_ = torch.zeros_like(p) if g_ is None else g_
                full = g_ + wd * p
                if step == 0:
                    grad1[names[i]] = g_.detach().clone()
                    adam1[names[i]] = full.detach().clone()
                m[i].mul_(b1).add_(full, alpha=1 - b1)
                v2[i].mul_(b2).addcmul_(full, full, value=1 - b2)
                bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                denom = (v2[i].sqrt() / bc2 ** 0.5).add_(eps)
                p.addcdiv_(m[i], denom, value=-lr / bc1)
    return {"losses": losses, "grad1": grad1, "adam1": adam1,
            "params": {n: p.detach() for n, p in zip(names, params)}}
