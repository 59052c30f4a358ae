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
  anything else    the leaf by name   (TypedDense/TypedHeads kernel
                                       [T, in, out] and bias [T, out],
                                       HEAT's skip [T])

`init_flax_like_` draws a module's weights from a seed with flax's
default initialisers (lecun-normal kernels, zero biases, BN 1/0/0/1), so
a run without weight files still sees realistic activation scales.
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
        node[name] = np.ascontiguousarray(_to_flax_layout(owner, leaf, arr))
    return out


# flax's lecun_normal: a normal truncated to +-2 std, rescaled by the std of
# that truncated normal so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_flax_like_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init with flax's defaults, in place. Kernels are
    lecun-normal with flax's fan-in (all axes but the output one: a
    [T, in, out] typed kernel has fan-in T*in); biases 0; BatchNorm scale
    1, bias 0, mean 0, var 1; HEAT's skip 1."""
    gen = torch.Generator().manual_seed(seed)
    for owner, _, leaf, t in _leaves(module):
        name = _leaf(owner, leaf)[1]
        if name == "kernel":
            fan_in = t[0].numel() if isinstance(owner, nn.Conv2d) else (
                t.shape[1] if isinstance(owner, nn.Linear)
                else t.numel() // t.shape[-1])
            w = torch.empty(t.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        elif name in ("scale", "var", "skip"):
            t.fill_(1.0)
        else:  # bias, mean
            t.zero_()
    return module
