"""The reference's torch checkpoints for the CNN featurizers, as flax-layout
numpy variable trees (counterpart of wsi_hgnn_tpu/models/featurizers/
convert.py; a copy, so the port imports nothing of the JAX package).

The reference loads three external checkpoints:
  * HoVer-Net PanNuke (`hovernet_fast_pannuke_type_tf2pytorch.tar`), with
    a DataParallel 'module.' strip and strict=False: keys the file lacks
    (the repo's custom fc1 head) keep their init;
  * KimiaNet DenseNet-121 weights, copied by ZIP ORDER onto the
    torchvision state dict's key order;
  * EfficientNet-B4 ImageNet weights under efficientnet_pytorch's names,
    whose 1000-way `_fc` the 1024-d feature head does not take.

Each converter takes a torch state dict as numpy arrays and returns
{'params': ..., 'batch_stats': ...} in the flax modules' layout, the form
`convert.load_flax_variables` and `fuse_kimianet` consume: conv OIHW ->
HWIO, linear [out, in] -> [in, out], BatchNorm weight/bias -> scale/bias
and running_mean/var -> batch_stats. `kimianet_state_dict`,
`hovernet_state_dict` and `efficientnet_state_dict` are the inverse maps,
which write flax trees as files in the reference's layout.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------- #
# generic helpers
# --------------------------------------------------------------------- #
def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """torch.load (tensors only, `weights_only`) -> {key: numpy}; unwraps
    the common checkpoint wrappers ('desc' for HoVer-Net tars,
    'state_dict', 'model')."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("desc", "state_dict", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if hasattr(v, "detach")}


def strip_dataparallel(sd: Dict[str, Any]) -> Dict[str, Any]:
    """convert_pytorch_checkpoint (graph_constructor.py:84-98)."""
    keys = list(sd.keys())
    if keys and all(k.split(".")[0] == "module" for k in keys):
        return {".".join(k.split(".")[1:]): v for k, v in sd.items()}
    return sd


def conv_w(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def linear_w(w: np.ndarray) -> np.ndarray:
    """[out, in] -> [in, out]."""
    return np.transpose(w, (1, 0))


def _set(tree: Dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _bn(params: Dict, stats: Dict, flax_path: List[str], sd: Dict, torch_prefix: str):
    _set(params, flax_path + ["scale"], sd[torch_prefix + ".weight"])
    _set(params, flax_path + ["bias"], sd[torch_prefix + ".bias"])
    _set(stats, flax_path + ["mean"], sd[torch_prefix + ".running_mean"])
    _set(stats, flax_path + ["var"], sd[torch_prefix + ".running_var"])


# --------------------------------------------------------------------- #
# HoVer-Net
# --------------------------------------------------------------------- #
_HOVER_RES_UNITS = {"d0": 3, "d1": 4, "d2": 6, "d3": 3}
_HOVER_DENSE_UNITS = {"u3": 8, "u2": 4}


def hovernet_torch_to_flax(sd: Dict[str, np.ndarray], nr_types: int = 6) -> Dict:
    """Map the reference's HoVerNet module names (net_desc.py:23-96) onto
    featurizers.hovernet.HoVerNet. Missing keys (fc1) keep random init —
    the reference's strict=False semantics."""
    sd = strip_dataparallel(sd)
    params: Dict = {}
    stats: Dict = {}

    def conv(flax_path, key, bias=False):
        if key + ".weight" in sd:
            _set(params, flax_path + ["kernel"], conv_w(sd[key + ".weight"]))
            if bias and key + ".bias" in sd:
                _set(params, flax_path + ["bias"], sd[key + ".bias"])

    def bn(flax_path, key):
        if key + ".weight" in sd:
            _bn(params, stats, flax_path + ["bn"], sd, key)

    conv(["conv0"], "conv0./")
    bn(["bn0"], "conv0.bn")

    for dname, units in _HOVER_RES_UNITS.items():
        conv([dname, "shortcut"], f"{dname}.shortcut")
        for i in range(units):
            base = f"{dname}.units.{i}"
            if i != 0:
                bn([dname, f"u{i}_preact"], f"{base}.preact/bn")
            conv([dname, f"u{i}_conv1"], f"{base}.conv1")
            bn([dname, f"u{i}_bn1"], f"{base}.conv1/bn")
            conv([dname, f"u{i}_conv2"], f"{base}.conv2")
            bn([dname, f"u{i}_bn2"], f"{base}.conv2/bn")
            conv([dname, f"u{i}_conv3"], f"{base}.conv3")
        bn([dname, "blk_bna"], f"{dname}.blk_bna.bn")

    conv(["conv_bot"], "conv_bot")

    for branch in ("tp", "np", "hv"):
        b = ["decoder_" + branch]
        t = f"decoder.{branch}"
        for u, nunits in _HOVER_DENSE_UNITS.items():
            conv(b + [f"{u}_conva"], f"{t}.{u}.conva")
            for i in range(nunits):
                db = b + [f"{u}_dense"]
                tb = f"{t}.{u}.dense.units.{i}"
                bn(db + [f"u{i}_preact"], f"{tb}.preact_bna/bn")
                conv(db + [f"u{i}_conv1"], f"{tb}.conv1")
                bn(db + [f"u{i}_bn1"], f"{tb}.conv1/bn")
                conv(db + [f"u{i}_conv2"], f"{tb}.conv2")
            bn(b + [f"{u}_dense", "blk_bna"], f"{t}.{u}.dense.blk_bna.bn")
            conv(b + [f"{u}_convf"], f"{t}.{u}.convf")
        conv(b + ["u1_conva"], f"{t}.u1.conva")
        bn(b + ["u0_bn"], f"{t}.u0.bn")
        conv(b + ["u0_conv"], f"{t}.u0.conv", bias=True)

    if "fc1.weight" in sd:  # usually absent (strict=False in the reference)
        w = sd["fc1.weight"]  # [1024, C*H*W] over torch's NCHW flatten
        if w.shape[1] == 1024 * 32 * 32:
            # our input flattens NHWC: reorder columns (C,H,W) -> (H,W,C)
            w = w.reshape(-1, 1024, 32, 32).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
        _set(params, ["fc1", "kernel"], linear_w(w))
        _set(params, ["fc1", "bias"], sd["fc1.bias"])

    return {"params": params, "batch_stats": stats}


# --------------------------------------------------------------------- #
# DenseNet121 / KimiaNet
# --------------------------------------------------------------------- #
_DENSENET_BLOCKS = (6, 12, 24, 16)


def densenet121_key_order() -> List[Tuple[str, str]]:
    """torchvision densenet121 `features` state-dict keys in registration
    order, (key, kind) with kind in {conv, bn_w, bn_b, bn_rm, bn_rv, nbt}.
    This IS the order KimiaNet's zip-load relies on
    (graph_constructor.py:182-186)."""
    order: List[Tuple[str, str]] = []

    def add_bn(prefix):
        order.extend([
            (f"{prefix}.weight", "bn_w"), (f"{prefix}.bias", "bn_b"),
            (f"{prefix}.running_mean", "bn_rm"),
            (f"{prefix}.running_var", "bn_rv"),
            (f"{prefix}.num_batches_tracked", "nbt"),
        ])

    order.append(("features.conv0.weight", "conv"))
    add_bn("features.norm0")
    for bi, n in enumerate(_DENSENET_BLOCKS, start=1):
        for li in range(1, n + 1):
            p = f"features.denseblock{bi}.denselayer{li}"
            add_bn(f"{p}.norm1")
            order.append((f"{p}.conv1.weight", "conv"))
            add_bn(f"{p}.norm2")
            order.append((f"{p}.conv2.weight", "conv"))
        if bi != len(_DENSENET_BLOCKS):
            p = f"features.transition{bi}"
            add_bn(f"{p}.norm")
            order.append((f"{p}.conv.weight", "conv"))
    add_bn("features.norm5")
    return order


def densenet_torch_to_flax(sd: Dict[str, np.ndarray], prefix: str = "features.") -> Dict:
    """torchvision-named densenet121 features -> featurizers.densenet
    DenseNet121 trees."""
    params: Dict = {}
    stats: Dict = {}

    def conv(flax_path, key):
        _set(params, flax_path + ["kernel"], conv_w(sd[key]))

    def bn(flax_path, key):
        _bn(params, stats, flax_path, sd, key)

    conv(["conv0"], f"{prefix}conv0.weight")
    bn(["norm0"], f"{prefix}norm0")
    for bi, n in enumerate(_DENSENET_BLOCKS, start=1):
        for li in range(1, n + 1):
            t = f"{prefix}denseblock{bi}.denselayer{li}"
            f = [f"denseblock{bi}_layer{li}"]
            bn(f + ["norm1"], f"{t}.norm1")
            conv(f + ["conv1"], f"{t}.conv1.weight")
            bn(f + ["norm2"], f"{t}.norm2")
            conv(f + ["conv2"], f"{t}.conv2.weight")
        if bi != len(_DENSENET_BLOCKS):
            bn([f"transition{bi}", "norm"], f"{prefix}transition{bi}.norm")
            conv([f"transition{bi}", "conv"], f"{prefix}transition{bi}.conv.weight")
    bn(["norm5"], f"{prefix}norm5")
    return {"params": params, "batch_stats": stats}


def load_kimianet(path) -> Dict:
    """Reproduce KimiaNet's zip-ordered load (graph_constructor.py:182-186):
    the checkpoint's values are copied positionally onto the torchvision
    densenet121 key order, then converted to the Flax KimiaNet trees
    (backbone + fc_4 head)."""
    raw = load_torch_state_dict(path)
    raw = strip_dataparallel(raw)
    values = list(raw.values())

    order = densenet121_key_order()
    # the fully_connected wrapper appends fc_4.{weight,bias} after features
    order = order + [("fc_4.weight", "linear"), ("fc_4.bias", "b")]
    if len(values) < len(order):
        raise ValueError(
            f"KimiaNet checkpoint has {len(values)} tensors, need {len(order)}"
        )
    sd = {k: v for (k, kind), v in zip(order, values)}

    trees = densenet_torch_to_flax(sd, prefix="features.")
    params = {"backbone": trees["params"]}
    stats = {"backbone": trees["batch_stats"]}
    params["fc_4"] = {
        "kernel": linear_w(sd["fc_4.weight"]),
        "bias": sd["fc_4.bias"],
    }
    return {"params": params, "batch_stats": stats}


# --------------------------------------------------------------------- #
# the inverse maps: flax trees as files in the reference's layout
# --------------------------------------------------------------------- #
def _leaf(tree: Dict, path: List[str]):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return np.asarray(tree)


def kimianet_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """KimiaNet flax variables as the reference weights file's tensors:
    torchvision densenet121 `features` keys in their order (with
    num_batches_tracked), then fc_4; load_kimianet reads them back."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for key, kind in densenet121_key_order():
        mods = key.split(".")[1:-1]
        if mods[0].startswith("denseblock"):
            mods = [f"{mods[0]}_layer{mods[1][len('denselayer'):]}"] + mods[2:]
        path = ["backbone"] + mods
        if kind == "conv":
            sd[key] = _leaf(p, path + ["kernel"]).transpose(3, 2, 0, 1)
        elif kind == "nbt":
            sd[key] = np.asarray(0, np.int64)
        else:
            coll, leaf = {"bn_w": (p, "scale"), "bn_b": (p, "bias"),
                          "bn_rm": (s, "mean"), "bn_rv": (s, "var")}[kind]
            sd[key] = _leaf(coll, path + [leaf])
    sd["fc_4.weight"] = linear_w(_leaf(p, ["fc_4", "kernel"]))
    sd["fc_4.bias"] = _leaf(p, ["fc_4", "bias"])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def hovernet_module_keys() -> List[Tuple[str, List[str], str]]:
    """(reference module name, flax path, 'conv' | 'bn') of every module
    hovernet_torch_to_flax maps, the tp/np/hv decoders included (fc1, a
    plain linear, aside)."""
    out = [("conv0./", ["conv0"], "conv"), ("conv0.bn", ["bn0"], "bn")]
    for d, units in _HOVER_RES_UNITS.items():
        out.append((f"{d}.shortcut", [d, "shortcut"], "conv"))
        for i in range(units):
            b = f"{d}.units.{i}"
            if i != 0:
                out.append((f"{b}.preact/bn", [d, f"u{i}_preact"], "bn"))
            for c in (1, 2):
                out.append((f"{b}.conv{c}", [d, f"u{i}_conv{c}"], "conv"))
                out.append((f"{b}.conv{c}/bn", [d, f"u{i}_bn{c}"], "bn"))
            out.append((f"{b}.conv3", [d, f"u{i}_conv3"], "conv"))
        out.append((f"{d}.blk_bna.bn", [d, "blk_bna"], "bn"))
    out.append(("conv_bot", ["conv_bot"], "conv"))
    for branch in ("tp", "np", "hv"):
        b, t = ["decoder_" + branch], f"decoder.{branch}"
        for u, nunits in _HOVER_DENSE_UNITS.items():
            out.append((f"{t}.{u}.conva", b + [f"{u}_conva"], "conv"))
            for i in range(nunits):
                db, tb = b + [f"{u}_dense"], f"{t}.{u}.dense.units.{i}"
                out += [(f"{tb}.preact_bna/bn", db + [f"u{i}_preact"], "bn"),
                        (f"{tb}.conv1", db + [f"u{i}_conv1"], "conv"),
                        (f"{tb}.conv1/bn", db + [f"u{i}_bn1"], "bn"),
                        (f"{tb}.conv2", db + [f"u{i}_conv2"], "conv")]
            out.append((f"{t}.{u}.dense.blk_bna.bn",
                        b + [f"{u}_dense", "blk_bna"], "bn"))
            out.append((f"{t}.{u}.convf", b + [f"{u}_convf"], "conv"))
        out.append((f"{t}.u1.conva", b + ["u1_conva"], "conv"))
        out.append((f"{t}.u0.bn", b + ["u0_bn"], "bn"))
        out.append((f"{t}.u0.conv", b + ["u0_conv"], "conv"))
    return out


def hovernet_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """HoVer-Net flax variables as the reference checkpoint's tensors,
    for the modules the tree holds (a typing-only tree has no np/hv
    decoders and no fc1; fc1 is written over torch's NCHW flatten);
    hovernet_torch_to_flax reads them back."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for key, path, kind in hovernet_module_keys():
        if kind == "conv":
            w = _leaf(p, path + ["kernel"])
            if w is None:
                continue
            sd[f"{key}.weight"] = w.transpose(3, 2, 0, 1)   # HWIO -> OIHW
            b = _leaf(p, path + ["bias"])
            if b is not None:
                sd[f"{key}.bias"] = b
        elif _leaf(p, path + ["bn", "scale"]) is not None:
            sd.update({f"{key}.weight": _leaf(p, path + ["bn", "scale"]),
                       f"{key}.bias": _leaf(p, path + ["bn", "bias"]),
                       f"{key}.running_mean": _leaf(s, path + ["bn", "mean"]),
                       f"{key}.running_var": _leaf(s, path + ["bn", "var"])})
    if _leaf(p, ["fc1", "kernel"]) is not None:
        sd["fc1.weight"] = _fc1_to_torch(_leaf(p, ["fc1", "kernel"]))
        sd["fc1.bias"] = _leaf(p, ["fc1", "bias"])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def _fc1_to_torch(kernel: np.ndarray) -> np.ndarray:
    """fc1's flax kernel [32*32*1024 (H, W, C), F] as the reference's
    nn.Linear weight [F, C*H*W] over torch's NCHW flatten."""
    f = kernel.shape[1]
    if kernel.shape[0] == 1024 * 32 * 32:
        kernel = kernel.reshape(32, 32, 1024, f).transpose(2, 0, 1, 3)
    return np.ascontiguousarray(kernel.reshape(-1, f).T)


# --------------------------------------------------------------------- #
# EfficientNet (efficientnet_pytorch naming)
# --------------------------------------------------------------------- #
def efficientnet_torch_to_flax(sd: Dict[str, np.ndarray],
                               num_classes: Optional[int] = None) -> Dict:
    """efficientnet_pytorch state dict (_conv_stem/_blocks.N._*/_fc) ->
    featurizers.efficientnet.EfficientNet trees. The reference's fc is
    freshly initialised (from_pretrained(num_classes=1024) re-inits it), so
    an absent or mismatched _fc is skipped (pass num_classes to accept a
    matching head). Strips DataParallel's 'module.'."""
    sd = strip_dataparallel(sd)
    params: Dict = {}
    stats: Dict = {}

    def conv(flax_path, key, bias=False):
        if key + ".weight" in sd:
            _set(params, flax_path + ["kernel"], conv_w(sd[key + ".weight"]))
            if bias and key + ".bias" in sd:
                _set(params, flax_path + ["bias"], sd[key + ".bias"])

    def bn(flax_path, key):
        if key + ".weight" in sd:
            _bn(params, stats, flax_path, sd, key)

    for key, path, kind in efficientnet_module_keys(_n_blocks(sd)):
        if kind == "bn":
            bn(path, key)
        else:
            conv(path, key, bias=kind == "conv_bias")
    if "_fc.weight" in sd and num_classes is not None and int(
            sd["_fc.weight"].shape[0]) == num_classes:
        _set(params, ["fc", "kernel"], linear_w(sd["_fc.weight"]))
        _set(params, ["fc", "bias"], sd["_fc.bias"])
    return {"params": params, "batch_stats": stats}


def _n_blocks(sd: Dict) -> int:
    i = 0
    while f"_blocks.{i}._depthwise_conv.weight" in sd:
        i += 1
    return i


def efficientnet_module_keys(n_blocks: int
                             ) -> List[Tuple[str, List[str], str]]:
    """(efficientnet_pytorch module name, flax path, 'conv' | 'conv_bias'
    | 'bn') of every module but the fc head, in the file's order."""
    out = [("_conv_stem", ["conv_stem"], "conv"), ("_bn0", ["bn_stem"], "bn")]
    for i in range(n_blocks):
        b, t = [f"block{i}"], f"_blocks.{i}"
        out += [(f"{t}._expand_conv", b + ["expand_conv"], "conv"),
                (f"{t}._bn0", b + ["bn0"], "bn"),
                (f"{t}._depthwise_conv", b + ["depthwise_conv"], "conv"),
                (f"{t}._bn1", b + ["bn1"], "bn"),
                (f"{t}._se_reduce", b + ["se_reduce"], "conv_bias"),
                (f"{t}._se_expand", b + ["se_expand"], "conv_bias"),
                (f"{t}._project_conv", b + ["project_conv"], "conv"),
                (f"{t}._bn2", b + ["bn2"], "bn")]
    out += [("_conv_head", ["conv_head"], "conv"), ("_bn1", ["bn_head"], "bn")]
    return out


def efficientnet_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """EfficientNet flax variables as an efficientnet_pytorch state dict
    (with the fc head as `_fc`); efficientnet_torch_to_flax reads it
    back."""
    p, s = variables["params"], variables["batch_stats"]
    n_blocks = sum(1 for k in p if k.startswith("block"))
    sd: Dict[str, np.ndarray] = {}
    for key, path, kind in efficientnet_module_keys(n_blocks):
        if kind == "bn":
            if _leaf(p, path + ["scale"]) is not None:
                sd.update({f"{key}.weight": _leaf(p, path + ["scale"]),
                           f"{key}.bias": _leaf(p, path + ["bias"]),
                           f"{key}.running_mean": _leaf(s, path + ["mean"]),
                           f"{key}.running_var": _leaf(s, path + ["var"])})
            continue
        w = _leaf(p, path + ["kernel"])
        if w is None:   # no expansion conv in expand-1 blocks
            continue
        sd[f"{key}.weight"] = w.transpose(3, 2, 0, 1)
        if kind == "conv_bias":
            sd[f"{key}.bias"] = _leaf(p, path + ["bias"])
    if _leaf(p, ["fc", "kernel"]) is not None:
        sd["_fc.weight"] = linear_w(_leaf(p, ["fc", "kernel"]))
        sd["_fc.bias"] = _leaf(p, ["fc", "bias"])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def merge_into(variables: Dict, converted: Dict) -> Dict:
    """Overlay converted trees onto initialised variables (a strict=False
    load): leaves present in `converted` replace the init values, cast to
    the init leaf's dtype; everything else stays. A converted key the
    module does not have, or a shape that differs, raises."""
    def overlay(init, conv):
        if not isinstance(conv, dict):
            if np.shape(init) != np.shape(conv):
                raise ValueError(
                    f"shape mismatch {np.shape(init)} vs {np.shape(conv)}")
            return np.asarray(conv, dtype=np.asarray(init).dtype)
        out = dict(init)
        for k, v in conv.items():
            if k not in init:
                raise KeyError(f"converted key {k!r} not in module variables")
            out[k] = overlay(init[k], v)
        return out

    return {col: overlay(variables[col], converted.get(col, {}))
            for col in variables}
