"""UNI2-h's elementwise passes between its GEMMs, one pass each: the
hand-written CUDA kernels (`csrc/vit_block.cu`) and their plain PyTorch
versions.

`swiglu(h)`: fc1's output [..., 2F] -> silu(h[..., :F]) * h[..., F:], the
packed SwiGLU (timm's GluMlp, gate_last=False). `add_layer_norm(x, gamma,
branch, norm)`: the f32 residual stream x += gamma * branch in place (a
LayerScale'd branch), then norm(x rounded to the norm's dtype), the next
LayerNorm's input; `branch=None` gives the LayerNorm alone, `norm=None`
the update alone (returning None). On the card both kernels equal the
unfused ops bit for bit: add_layer_norm takes torch's LayerNorm
statistics step for step (see the kernel source).

The in-place update is the port's: the ViT runs frozen, under
`torch.inference_mode()`, and nothing else reads the stream's old value.
The kernels have no backward: on the card the wrappers raise for an
operand that needs a gradient, for a dtype other than bf16 (the f32
stream aside), and for rows that are not contiguous, 16-byte aligned and
a multiple of 16 bytes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import _build
from .densenet import _require


def swiglu_reference(h: torch.Tensor) -> torch.Tensor:
    """The unfused ops: SiLU of the first half times the second."""
    a, b = h.chunk(2, dim=-1)
    return F.silu(a) * b


def add_layer_norm_reference(x: torch.Tensor, gamma: Optional[torch.Tensor],
                             branch: Optional[torch.Tensor],
                             norm: Optional[nn.LayerNorm]
                             ) -> Optional[torch.Tensor]:
    """The unfused ops: x.addcmul_(gamma, branch), then norm(x.to(the
    norm's dtype))."""
    if branch is not None:
        x.addcmul_(gamma, branch)
    return None if norm is None else norm(x.to(norm.weight.dtype))


_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("vit_block"), name)
    fn.argtypes = ([_P, _P, ctypes.c_int64, ctypes.c_int, _P]
                   if name == "vit_swiglu_bf16" else
                   [_P] * 6 + [ctypes.c_float, ctypes.c_int64, ctypes.c_int,
                               _P])
    fn.restype = ctypes.c_int
    return fn


def _no_grad(*ts) -> None:
    _require(not (torch.is_grad_enabled()
                  and any(t is not None and t.requires_grad for t in ts)),
             "the ViT kernels have no backward: run them under "
             "torch.inference_mode() or torch.no_grad()")


def _rows(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    _require(t.dtype == dtype, f"{what} must be {dtype}, not {t.dtype}")
    _require(t.is_contiguous() and t.data_ptr() % 16 == 0
             and t.shape[-1] * t.element_size() % 16 == 0,
             f"{what} must be contiguous, 16-byte aligned, in rows of a "
             f"multiple of 16 bytes")


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """silu(h[..., :F]) * h[..., F:] as [..., F]. A CUDA tensor launches
    csrc/vit_block.cu; a CPU tensor runs the plain version."""
    if h.device.type == "cpu":
        return swiglu_reference(h)
    _no_grad(h)
    _require(h.dim() >= 1 and h.shape[-1] % 2 == 0,
             "swiglu takes rows of an even width")
    _rows(h, torch.bfloat16, "swiglu's input")
    f = h.shape[-1] // 2
    _require(f % 8 == 0, "swiglu needs halves of 16-byte rows")
    out = torch.empty((*h.shape[:-1], f), dtype=h.dtype, device=h.device)
    rows = h.numel() // h.shape[-1] if h.shape[-1] else 0
    if rows:
        with torch.cuda.device(h.device):
            status = _kernel("vit_swiglu_bf16")(
                h.data_ptr(), out.data_ptr(), rows, f,
                torch.cuda.current_stream(h.device).cuda_stream)
        _build.check(status, "swiglu")
        swiglu.launches += 1
    return out


swiglu.launches = 0


def add_layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
                   branch: Optional[torch.Tensor],
                   norm: Optional[nn.LayerNorm]) -> Optional[torch.Tensor]:
    """x += gamma * branch in place (none when branch is None), then
    norm(x.to(the norm's dtype)) (None when norm is None). A CUDA tensor
    launches csrc/vit_block.cu; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, gamma, branch, norm)
    _require(branch is not None or norm is not None,
             "add_layer_norm needs a branch, a norm or both")
    _rows(x, torch.float32, "the residual stream")
    d = x.shape[-1]
    _require(d <= 4096, f"add_layer_norm takes rows of at most 4096, not "
             f"{d}")
    vectors = []     # (what, a [d] parameter)
    if branch is not None:
        _require(gamma is not None, "an update needs its LayerScale")
        _rows(branch, torch.bfloat16, "the branch")
        _require(branch.shape == x.shape and branch.device == x.device,
                 "the branch must match the stream's shape and device")
        vectors.append(("LayerScale", gamma))
    if norm is not None:
        _require(norm.weight is not None and norm.bias is not None
                 and tuple(norm.normalized_shape) == (d,),
                 "add_layer_norm needs an affine LayerNorm of the row width")
        vectors += [("the LayerNorm's weight", norm.weight),
                    ("the LayerNorm's bias", norm.bias)]
    _no_grad(x, branch, *(p for _, p in vectors))
    for what, p in vectors:
        _rows(p, torch.bfloat16, what)
        _require(p.numel() == d and p.device == x.device,
                 f"{what} must hold one value a column, on the stream's "
                 f"device")
    y = (None if norm is None else
         torch.empty(x.shape, dtype=torch.bfloat16, device=x.device))
    rows = x.numel() // d if d else 0
    if rows:
        with torch.cuda.device(x.device):
            status = _kernel("vit_add_layer_norm")(
                x.data_ptr(), None if branch is None else gamma.data_ptr(),
                None if branch is None else branch.data_ptr(),
                None if norm is None else norm.weight.data_ptr(),
                None if norm is None else norm.bias.data_ptr(),
                None if y is None else y.data_ptr(),
                0.0 if norm is None else float(norm.eps), rows, d,
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(status, "add_layer_norm")
        add_layer_norm.launches += 1
    return y


add_layer_norm.launches = 0
