"""HoVer-Net's BatchNorm (inference) + ReLU, alone or after a residual
add, in one pass over a channels-last map: the hand-written CUDA kernel
(`csrc/bn_act.cu`) and its plain PyTorch version.

Three forms, one launch each (`bn_act(x, bn, residual, keep_sum)`):
y = relu(bn(x)); s = x + residual, y = relu(bn(s)) returning (s, y), the
next unit's shortcut and its input; and the same returning y alone, for a
block's last sum, which only the block's own BatchNorm reads. The kernel
reproduces the unfused card path's arithmetic (the sum rounded to the
storage type, then torch's eval BatchNorm formula in f32 with the module's
own weight, bias and running statistics, its rsqrt included; see the
kernel source), so its result equals `bn_relu_reference` on the card bit
for bit: in bf16 always, in f32 where torch's own BatchNorm kernel runs
(with cuDNN on, torch gives f32 maps to cuDNN, which rounds the formula
its own way).

HoVer-Net runs frozen, under `torch.inference_mode()`, and the kernel has
no backward: on the card the wrapper raises for a BatchNorm in training
mode and for an operand that needs a gradient, and for a map that is not
contiguous in channels-last order (the layout the card's HoVer-Net keeps).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import _build
from .densenet import _DTYPES, _require


def bn_relu_reference(x: torch.Tensor, bn: nn.BatchNorm2d,
                      residual: Optional[torch.Tensor] = None,
                      keep_sum: bool = False):
    """The unfused ops: relu(bn(x)), or s = x + residual and relu(bn(s)),
    returning (s, y) when keep_sum."""
    s = x if residual is None else x + residual
    y = F.relu(bn(s))
    return (s, y) if keep_sum else y


_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _kernel(suffix: str):
    fn = getattr(_build.load("bn_act"), f"bn_act_{suffix}")
    fn.argtypes = [_P] * 8 + [ctypes.c_float, ctypes.c_int64, ctypes.c_int,
                              _P]
    fn.restype = ctypes.c_int
    return fn


def _card_args(x: torch.Tensor, bn: nn.BatchNorm2d,
               residual: Optional[torch.Tensor], keep_sum: bool) -> str:
    """Validate a launch's operands; returns the dtype suffix."""
    _require(not bn.training, "bn_act runs a BatchNorm in eval mode only")
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    _require(all(p is not None for p in params),
             "bn_act needs an affine BatchNorm with running statistics")
    maps = (x,) if residual is None else (x, residual)
    _require(not (torch.is_grad_enabled()
                  and any(t.requires_grad for t in (*maps, bn.weight,
                                                    bn.bias))),
             "bn_act has no backward: run it under torch.inference_mode() "
             "or torch.no_grad()")
    _require(keep_sum is False or residual is not None,
             "keep_sum needs a residual")
    _require(x.dtype in _DTYPES, f"unsupported storage dtype {x.dtype}")
    _require(x.dim() == 4 and x.shape[1] * x.element_size() % 16 == 0,
             "bn_act takes [N, C, H, W] maps of 16-byte channel rows")
    for t in maps:
        _require(t.shape == x.shape and t.dtype == x.dtype
                 and t.device == x.device
                 and t.is_contiguous(memory_format=torch.channels_last)
                 and t.data_ptr() % 16 == 0,
                 "maps must be contiguous channels-last, 16-byte aligned, "
                 "of one shape, dtype and device")
    for p in params:
        _require(p.dtype == x.dtype and p.device == x.device
                 and p.is_contiguous() and p.numel() == x.shape[1],
                 "BatchNorm parameters must match the map's channels, "
                 "dtype and device")
    return _DTYPES[x.dtype]


def bn_act(x: torch.Tensor, bn: nn.BatchNorm2d,
           residual: Optional[torch.Tensor] = None, keep_sum: bool = False):
    """relu(bn(x)), or relu(bn(x + residual)) with the sum too when
    keep_sum ((s, y)). A CUDA tensor launches csrc/bn_act.cu; a CPU tensor
    runs the plain version."""
    if x.device.type == "cpu":
        return bn_relu_reference(x, bn, residual, keep_sum)
    suffix = _card_args(x, bn, residual, keep_sum)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    s = (torch.empty_like(x, memory_format=torch.channels_last)
         if keep_sum else None)
    rows = x.numel() // x.shape[1]
    if rows:
        with torch.cuda.device(x.device):
            status = _kernel(suffix)(
                x.data_ptr(), None if residual is None else residual.data_ptr(),
                None if s is None else s.data_ptr(), y.data_ptr(),
                bn.weight.data_ptr(), bn.bias.data_ptr(),
                bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
                float(bn.eps), rows, x.shape[1],
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(status, "bn_act")
        bn_act.launches += 1
    return (s, y) if keep_sum else y


bn_act.launches = 0
