"""The weight bridge: flax variable trees <-> the port's modules.

A flax tree arrives as nested dicts of numpy arrays ({"params": ...,
"batch_stats": ...}); nothing here imports JAX. The port's modules name
their submodules exactly as the flax modules are named, so a torch module
path `gcs_0.k_linears` is the flax path ("gcs_0", "k_linears"), and each
leaf maps by the kind of module that owns it:

  nn.Conv2d        weight OIHW        <- kernel HWIO (grouped: [kh, kw, in/g, out])
  nn.Linear        weight [out, in]   <- kernel [in, out]
  nn.BatchNorm2d   weight, bias       <- params scale, bias
                   running_mean/var   <- batch_stats mean, var
  nn.LayerNorm     weight, bias       <- params scale, bias
  a module with a  its leaves in the named collection (MaskedBatchNorm's
  flax_collections   buffers mean, var <- batch_stats mean, var)
  map
  anything else    the leaf by name   (TypedDense/TypedHeads kernel
                                       [T, in, out] and bias [T, out],
                                       HEAT's skip [T], GAT's attn_l/r
                                       [1, H, F], GIN's scalar eps, HGT's
                                       relation_att/msg/pri, H2MIL's
                                       att_l/att_r/t_att_l/t_att_r
                                       [1, H, C] and weight_1/weight_2
                                       [1, D], per-type
                                       LayerNorm scale/bias [T, d], DSMIL's
                                       fcc_kernel [C, C, V], GTN's
                                       cls_token)

`init_flax_like_` draws a module's weights from a seed with flax's
default initialisers (lecun-normal kernels, xavier-uniform HGT relation
tensors and H2MIL attention vectors, xavier-normal GAT attention vectors,
U[0, 1) IHPool fitness weights, zero biases, BN 1/0/0/1),
so a run without weight files starts where a flax run would (DSMIL's
fcc_kernel, whose flax initialiser takes its fan-in over the last two
axes, included).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}


def _leaf(owner: nn.Module, leaf: str) -> Tuple[str, str]:
    """(collection, flax leaf name) of a torch leaf."""
    if isinstance(owner, nn.BatchNorm2d):
        return _BN[leaf]
    if isinstance(owner, nn.LayerNorm):
        return "params", {"weight": "scale"}.get(leaf, leaf)
    coll = getattr(owner, "flax_collections", {}).get(leaf)
    if coll is not None:
        return coll, leaf
    if isinstance(owner, (nn.Conv2d, nn.Linear)) and leaf == "weight":
        return "params", "kernel"
    return "params", leaf


def _to_torch_layout(owner: nn.Module, leaf: str, arr: np.ndarray):
    if leaf == "weight" and isinstance(owner, nn.Conv2d):
        return arr.transpose(3, 2, 0, 1)
    if leaf == "weight" and isinstance(owner, nn.Linear):
        return arr.T
    return arr


def _to_flax_layout(owner: nn.Module, leaf: str, arr: np.ndarray):
    if leaf == "weight" and isinstance(owner, nn.Conv2d):
        return arr.transpose(2, 3, 1, 0)
    if leaf == "weight" and isinstance(owner, nn.Linear):
        return arr.T
    return arr


def _leaves(module: nn.Module):
    """(owner module, module path keys, leaf name, tensor) for every
    parameter and float buffer."""
    for path, owner in module.named_modules():
        keys = path.split(".") if path else []
        tensors = list(owner.named_parameters(recurse=False)) + [
            (n, b) for n, b in owner.named_buffers(recurse=False)
            if b.is_floating_point()]
        for leaf, t in tensors:
            yield owner, keys, leaf, t


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: Dict) -> nn.Module:
    """Copy a flax variable tree into `module` in place (extra flax
    entries, such as branches the port does not run, are ignored; a
    missing or mis-shaped entry raises). Returns the module."""
    for owner, keys, leaf, t in _leaves(module):
        coll, name = _leaf(owner, leaf)
        node = variables[coll]
        try:
            for key in keys:
                node = node[key]
            arr = np.asarray(node[name], np.float32)
        except KeyError as e:
            raise KeyError(f"flax tree has no {coll}/{'/'.join(keys)}/{name}"
                           ) from e
        arr = _to_torch_layout(owner, leaf, arr)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(keys)}/{name}: flax shape "
                             f"{arr.shape} vs torch {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr, np.float32)))
    return module


@torch.no_grad()
def to_flax_variables(module: nn.Module) -> Dict:
    """The inverse map: a flax-layout numpy tree of `module`'s weights."""
    out: Dict = {}
    for owner, keys, leaf, t in _leaves(module):
        coll, name = _leaf(owner, leaf)
        node = out.setdefault(coll, {})
        for key in keys:
            node = node.setdefault(key, {})
        arr = t.detach().float().cpu().numpy()
        node[name] = np.array(_to_flax_layout(owner, leaf, arr), order="C")
    return out


def params_to_flax(module: nn.Module, values: Dict[str, torch.Tensor]
                   ) -> Dict:
    """A flax 'params' subtree in flax layout from `values`, tensors
    shaped like `module`'s parameters and keyed by their names
    (`module.named_parameters()`): how optimizer moments are written in
    the flax tree's layout."""
    out: Dict = {}
    for owner, keys, leaf, _ in _leaves(module):
        coll, name = _leaf(owner, leaf)
        if coll != "params":
            continue
        node = out
        for key in keys:
            node = node.setdefault(key, {})
        arr = values[".".join(keys + [leaf])].detach().float().cpu().numpy()
        node[name] = np.array(_to_flax_layout(owner, leaf, arr), order="C")
    return out


def params_from_flax(module: nn.Module, tree: Dict) -> Dict[str, np.ndarray]:
    """The inverse of params_to_flax: torch-layout f32 arrays keyed by
    parameter name, read from a flax 'params' subtree (shape-checked)."""
    out: Dict[str, np.ndarray] = {}
    for owner, keys, leaf, t in _leaves(module):
        coll, name = _leaf(owner, leaf)
        if coll != "params":
            continue
        node = tree
        for key in keys:
            node = node[key]
        arr = _to_torch_layout(owner, leaf, np.asarray(node[name], np.float32))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(keys)}/{name}: flax shape "
                             f"{arr.shape} vs torch {tuple(t.shape)}")
        out[".".join(keys + [leaf])] = np.array(arr, order="C")
    return out


# flax's truncated-normal initialisers: a normal truncated to +-2 std,
# rescaled by the std of that truncated normal
_TRUNC_STD = 0.87962566103423978
# leaves flax initialises to ones; every other non-kernel leaf is zeros
_ONES = ("scale", "var", "skip", "relation_pri")
# xavier-uniform leaves (HGT's relation tensors, H2MIL's RAConv attention)
_XAVIER_UNIFORM = ("relation_att", "relation_msg", "att_l", "att_r",
                   "t_att_l", "t_att_r")
# U[0, 1) leaves (H2MIL's IHPool fitness projections)
_UNIFORM = ("weight_1", "weight_2")


def _flax_fans(shape) -> Tuple[int, int]:
    """flax variance_scaling's (fan_in, fan_out) of a flax-layout shape:
    in axis -2, out axis -1, the receptive field the product of the rest
    (so a [T, in, out] typed kernel has fan-in T*in, not torch's rule)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax's truncated normal, drawn on `gen`'s device."""
    w = torch.empty(shape, device=gen.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std / _TRUNC_STD)


@torch.no_grad()
def init_flax_like_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init with flax's defaults, in place: kernels lecun-normal
    (variance 1/fan_in), HGT's relation_att/relation_msg and H2MIL's
    att_l/att_r/t_att_l/t_att_r xavier-uniform and GAT's attn_l/attn_r
    xavier-normal (variance 2/(fan_in+fan_out)), all with flax's fans;
    IHPool's weight_1/weight_2 U[0, 1); relation_pri, skip, scales and
    running variances 1; biases, eps and running means 0."""
    gen = torch.Generator().manual_seed(seed)
    for owner, _, leaf, t in _leaves(module):
        name = _leaf(owner, leaf)[1]
        if name in _UNIFORM:
            t.copy_(torch.rand(t.shape, generator=gen))
            continue
        if name not in ("kernel", "attn_l", "attn_r", "fcc_kernel"
                        ) + _XAVIER_UNIFORM:
            t.fill_(1.0 if name in _ONES else 0.0)
            continue
        # fans from the flax layout; the draw is in the torch layout
        fan_in, fan_out = _flax_fans(_to_flax_layout(
            owner, leaf, np.empty(t.shape, np.uint8)).shape)
        if name == "kernel":
            t.copy_(trunc_normal(t.shape, math.sqrt(1.0 / fan_in), gen))
        elif name == "fcc_kernel":   # variance_scaling, in_axis=(-2, -1)
            t.copy_(trunc_normal(t.shape, math.sqrt(
                1.0 / (t.shape[-2] * t.shape[-1])), gen))
        elif name in _XAVIER_UNIFORM:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * limit)
        else:  # attn_l, attn_r
            t.copy_(trunc_normal(t.shape, math.sqrt(2.0 / (fan_in + fan_out)),
                                  gen))
    return module
