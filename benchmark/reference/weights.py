"""Seeded weights for every model the benchmark runs, made on the device.

Each model has a spec: its flax-layout variable tree as (path, shape,
kind) rows, written here from the published architectures (KimiaNet's
DenseNet-121, HoVer-Net's 'fast' typing net, HEAT4, HGT). The flax
layout is the program's weight interface too, so one tree goes to both
sides: the reference reads the device tensors, the program gets them as
numpy through its loaders.

`make_weights` draws one normal vector for a whole model from a
`torch.Generator` on the device and shapes it into the leaves:
  * kernel:  N(0, 1/fan_in), fan_in the product of all but the last axis
             of a conv kernel (HWIO), else the second-to-last axis;
  * scale, var, pri, skip: positive, near 1 (exp of N(0, 0.1^2));
  * bias, mean: N(0, 0.05^2);
so BatchNorm folding and every bias take part with values that are not
the identity.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]

DENSENET_BLOCKS = (6, 12, 24, 16)
GROWTH = 32


def _bn(spec: Spec, prefix: str, ch: int, params: str = "params",
        stats: str = "batch_stats") -> None:
    spec.append((f"{params}/{prefix}/scale", (ch,), "scale"))
    spec.append((f"{params}/{prefix}/bias", (ch,), "bias"))
    spec.append((f"{stats}/{prefix}/mean", (ch,), "mean"))
    spec.append((f"{stats}/{prefix}/var", (ch,), "var"))


def _conv(spec: Spec, prefix: str, kh: int, cin: int, cout: int,
          bias: bool = False) -> None:
    spec.append((f"params/{prefix}/kernel", (kh, kh, cin, cout), "conv"))
    if bias:
        spec.append((f"params/{prefix}/bias", (cout,), "bias"))


def kimianet_spec() -> Spec:
    """KimiaNet: DenseNet-121 features (blocks 6/12/24/16, growth 32) and
    the fc_4 head."""
    spec: Spec = []
    b = "backbone"
    _conv(spec, f"{b}/conv0", 7, 3, 64)
    _bn(spec, f"{b}/norm0", 64)
    ch = 64
    for bi, n_layers in enumerate(DENSENET_BLOCKS):
        for li in range(n_layers):
            p = f"{b}/denseblock{bi + 1}_layer{li + 1}"
            _bn(spec, f"{p}/norm1", ch)
            _conv(spec, f"{p}/conv1", 1, ch, 4 * GROWTH)
            _bn(spec, f"{p}/norm2", 4 * GROWTH)
            _conv(spec, f"{p}/conv2", 3, 4 * GROWTH, GROWTH)
            ch += GROWTH
        if bi != len(DENSENET_BLOCKS) - 1:
            _bn(spec, f"{b}/transition{bi + 1}/norm", ch)
            _conv(spec, f"{b}/transition{bi + 1}/conv", 1, ch, ch // 2)
            ch //= 2
    _bn(spec, f"{b}/norm5", ch)
    spec.append(("params/fc_4/kernel", (ch, 512), "kernel"))
    spec.append(("params/fc_4/bias", (512,), "bias"))
    return spec


HOVER_RES = (("d0", 64, (64, 64, 256), 3), ("d1", 256, (128, 128, 512), 4),
             ("d2", 512, (256, 256, 1024), 6), ("d3", 1024, (512, 512, 2048), 3))
HOVER_DENSE = (("u3", 1024, 256, 8, 512), ("u2", 512, 128, 4, 256))


def hovernet_typing_spec(nr_types: int = 6, ksize: int = 3) -> Spec:
    """HoVer-Net's typing net: the pre-activation ResNet-50 encoder,
    conv_bot and the tp decoder ('fast' mode: 3x3 decoder convs)."""
    spec: Spec = []
    _conv(spec, "conv0", 7, 3, 64)
    _bn(spec, "bn0/bn", 64)
    for name, cin, (c1, c2, c3), units in HOVER_RES:
        _conv(spec, f"{name}/shortcut", 1, cin, c3)
        for u in range(units):
            ci = cin if u == 0 else c3
            if u:
                _bn(spec, f"{name}/u{u}_preact/bn", ci)
            _conv(spec, f"{name}/u{u}_conv1", 1, ci, c1)
            _bn(spec, f"{name}/u{u}_bn1/bn", c1)
            _conv(spec, f"{name}/u{u}_conv2", 3, c1, c2)
            _bn(spec, f"{name}/u{u}_bn2/bn", c2)
            _conv(spec, f"{name}/u{u}_conv3", 1, c2, c3)
        _bn(spec, f"{name}/blk_bna/bn", c3)
    _conv(spec, "conv_bot", 1, 2048, 1024)
    d = "decoder_tp"
    for u, cin, cmid, units, cout in HOVER_DENSE:
        _conv(spec, f"{d}/{u}_conva", ksize, cin, cmid)
        ch = cmid
        for i in range(units):
            _bn(spec, f"{d}/{u}_dense/u{i}_preact/bn", ch)
            _conv(spec, f"{d}/{u}_dense/u{i}_conv1", 1, ch, 128)
            _bn(spec, f"{d}/{u}_dense/u{i}_bn1/bn", 128)
            _conv(spec, f"{d}/{u}_dense/u{i}_conv2", ksize, 128 // 4, 32)
            ch += 32
        _bn(spec, f"{d}/{u}_dense/blk_bna/bn", ch)
        _conv(spec, f"{d}/{u}_convf", 1, cout, cout)
    _conv(spec, f"{d}/u1_conva", ksize, 256, 64)
    _bn(spec, f"{d}/u0_bn/bn", 64)
    _conv(spec, f"{d}/u0_conv", 1, 64, nr_types, bias=True)
    return spec


def _typed(spec: Spec, prefix: str, t: int, din: int, dout: int) -> None:
    spec.append((f"params/{prefix}/kernel", (t, din, dout), "kernel"))
    spec.append((f"params/{prefix}/bias", (t, dout), "bias"))


def heat4_spec(gnn: Dict) -> Spec:
    """HEATNet4 (the lattice twin's tree; the TypedGraph model's is the
    same)."""
    t, d_in, hid = int(gnn["n_node_types"]), int(gnn["in_dim"]), int(gnn["hidden_dim"])
    embed = 256
    spec: Spec = []
    _typed(spec, "adapt_ws", t, d_in, hid)
    for i in range(int(gnn["num_layers"])):
        p = f"gcs_{i}"
        spec.append((f"params/{p}/skip", (t,), "skip"))
        for name in ("k_linears", "q_linears", "v_linears", "a_linears"):
            _typed(spec, f"{p}/{name}", t, hid, hid)
        spec.append((f"params/{p}/e_linear/kernel", (1, 1), "kernel"))
        spec.append((f"params/{p}/e_linear/bias", (1,), "bias"))
    _typed(spec, "linears_prediction", t, hid, embed)
    for k in range(t):
        spec.append((f"params/attn_{k}/op/kernel", (embed, 1), "kernel"))
    spec.append(("params/head_2/kernel", (t * embed, embed), "kernel"))
    spec.append(("params/head_2/bias", (embed,), "bias"))
    spec.append(("params/head_1/kernel", (embed, 64), "kernel"))
    spec.append(("params/head_1/bias", (64,), "bias"))
    spec.append(("params/head/kernel", (64, int(gnn["out_dim"])), "kernel"))
    spec.append(("params/head/bias", (int(gnn["out_dim"]),), "bias"))
    return spec


def hgt_spec(gnn: Dict) -> Spec:
    t, d_in, hid = int(gnn["n_node_types"]), int(gnn["in_dim"]), int(gnn["hidden_dim"])
    heads, out = int(gnn["num_heads"]), int(gnn["out_dim"])
    n_rel = len(gnn.get("edge_types", ("pos", "neg"))) * t * t
    dk = hid // heads
    spec: Spec = []
    _typed(spec, "adapt_ws", t, d_in, hid)
    for i in range(int(gnn["num_layers"])):
        _typed(spec, f"pred_{i}", t, hid, out)
        p = f"gcs_{i}"
        spec.append((f"params/{p}/relation_att", (n_rel, heads, dk, dk), "kernel"))
        spec.append((f"params/{p}/relation_msg", (n_rel, heads, dk, dk), "kernel"))
        spec.append((f"params/{p}/relation_pri", (n_rel, heads), "pri"))
        spec.append((f"params/{p}/skip", (t,), "skip"))
        for name in ("k_linears", "q_linears", "v_linears", "a_linears"):
            _typed(spec, f"{p}/{name}", t, hid, hid)
        spec.append((f"params/{p}/norms/scale", (t, hid), "scale"))
        spec.append((f"params/{p}/norms/bias", (t, hid), "bias"))
    return spec


def _fan_in(shape: Sequence[int], kind: str) -> int:
    if kind == "conv":
        return int(np.prod(shape[:-1]))
    return int(shape[-2])


def make_weights(spec: Spec, seed: int, device) -> Dict:
    """The spec's tree of f32 tensors on `device`, from one draw of a
    generator seeded with `seed` on that device."""
    device = torch.device(device)
    sizes = [int(np.prod(s)) for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree: Dict = {}
    off = 0
    for (path, shape, kind), n in zip(spec, sizes):
        x = flat[off:off + n].reshape(shape)
        off += n
        if kind in ("kernel", "conv"):
            x = x * math.sqrt(1.0 / _fan_in(shape, kind))
        elif kind in ("scale", "var", "pri", "skip"):
            x = torch.exp(0.1 * x)
        else:  # bias, mean
            x = 0.05 * x
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x.contiguous()
    return tree


def to_numpy(tree: Dict) -> Dict:
    """The same tree as numpy (the program's weight interface)."""
    return {k: to_numpy(v) if isinstance(v, dict) else
            v.detach().cpu().numpy() for k, v in tree.items()}


def leaves(tree: Dict, prefix: str = ""):
    """(path, tensor) of every leaf, in tree order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v
