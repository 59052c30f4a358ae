"""The paper's GAT, plain, on edge lists: the reference repository's GAT
model over DGL's GATConv, as its parser builds it from
configs/BRCA/GAT_*.yml.

  * heads [num_heads] * num_layers + [num_out_heads] ([4, 4, 1] for the
    BRCA file); residual off whatever the file says (the parser never
    passes it); dropouts off (evaluation);
  * for i = 0..num_layers: the mean of h_i over the slide's nodes through
    pred_i (a linear map to out_dim), then h_{i+1} = GATConv_i(h_i) with
    its heads flattened and LeakyReLU(0.01) after all but the last; the
    logits are the mean of the num_layers + 1 heads' (the last GATConv's
    output reaches none);
  * GATConv (DGL): z = h W (no bias), el = <z, attn_l> and er = <z,
    attn_r> per head, e = LeakyReLU_0.2(el[src] + er[dst]), a softmax
    over each destination's in-edges, out[dst] = sum alpha z[src], plus
    the bias;
  * the graph: reference/gnn.py's slide graph and one self-loop a node
    (dgl.add_self_loop, which the reference's homogeneous loader adds).

Every product goes through a `Prec` (the "tf32" control). The weight
spec is the flax-layout tree the program loads (reference/weights.py's
kinds: kernels N(0, 1/fan_in); attn_l, attn_r and biases N(0, 0.05^2),
the attention vectors near DGL's xavier-normal init, std 0.04 here).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .gnn import Graph, segment_softmax
from .precision import Prec
from .weights import Spec


def heads(gnn: Dict):
    n = int(gnn["num_layers"])
    return [int(gnn["num_heads"])] * n + [int(gnn["num_out_heads"])]


def spec(gnn: Dict) -> Spec:
    d, hid, out = int(gnn["in_dim"]), int(gnn["hidden_dim"]), int(gnn["out_dim"])
    hs = heads(gnn)
    rows: Spec = []
    for i, h in enumerate(hs):
        feats = out if i == len(hs) - 1 else hid
        rows.append((f"params/pred_{i}/kernel", (d, out), "kernel"))
        rows.append((f"params/pred_{i}/bias", (out,), "bias"))
        rows.append((f"params/gat_{i}/attn_l", (1, h, feats), "bias"))
        rows.append((f"params/gat_{i}/attn_r", (1, h, feats), "bias"))
        rows.append((f"params/gat_{i}/bias", (h, feats), "bias"))
        rows.append((f"params/gat_{i}/fc/kernel", (d, h * feats), "kernel"))
        d = h * feats
    return rows


def logits(w: Dict, g: Graph, gnn: Dict, prec: Prec) -> torch.Tensor:
    """[1, out_dim] logits of one slide graph (self-loops added here)."""
    p = w["params"]
    n = g.feat.shape[0]
    loops = torch.arange(n, device=g.feat.device)
    src = torch.cat([g.src, loops])
    dst = torch.cat([g.dst, loops])
    live = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    h = g.feat
    hs = heads(gnn)
    outs = []
    for i, nh in enumerate(hs):
        lp = p[f"gat_{i}"]
        pooled = h.mean(0, keepdim=True)
        outs.append(prec.mm(pooled, p[f"pred_{i}"]["kernel"]) + p[f"pred_{i}"]["bias"])
        z = prec.mm(h, lp["fc"]["kernel"]).reshape(n, nh, -1)
        el = (z * lp["attn_l"]).sum(-1)
        er = (z * lp["attn_r"]).sum(-1)
        e = F.leaky_relu(el[src] + er[dst], 0.2)
        alpha = segment_softmax(e, dst, n, live)
        msg = (alpha[:, :, None] * z[src]).reshape(src.shape[0], -1)
        out = h.new_zeros(n, msg.shape[1]).index_add(0, dst, msg)
        out = out.reshape(n, nh, -1) + lp["bias"]
        if i != len(hs) - 1:
            out = F.leaky_relu(out, 0.01)
        h = out.reshape(n, -1)
    return torch.stack(outs).mean(0)


def forward_flops(n: int, e: int, gnn: Dict) -> float:
    """GAT on n nodes and e edges (self-loops included): each layer's
    feature map, its el and er, and the messages; the pooled heads are
    left out (under 1e-5 of the rest)."""
    d, hid, out = int(gnn["in_dim"]), int(gnn["hidden_dim"]), int(gnn["out_dim"])
    hs = heads(gnn)
    total = 0.0
    for i, nh in enumerate(hs):
        width = nh * (out if i == len(hs) - 1 else hid)
        total += 2.0 * n * d * width + 2 * 2.0 * n * width + 2.0 * e * width
        d = width
    return total
