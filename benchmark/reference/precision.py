"""The arithmetic the reference computes in.

`Prec("f32")` is the reference proper: full float32 products, with the
card's TF32 shortcuts switched off. The other two are the controls that
the correctness limits are calibrated against (PERF.md, section 2): the
same reference in the nearest precision below the one the configuration
states.

  * "tf32": every product's operands rounded to TF32 (10-bit mantissa,
    round to nearest even) and accumulated in f32, what the tensor cores
    do with `allow_tf32`, in the backward products too; emulated by
    rounding, so the CPU computes it as well.
  * "fp8": every convolution's operands scaled per tensor into float8
    e4m3 (3-bit mantissa) and back, accumulated in f32: per-tensor scaled
    fp8 inference, the step below the CNNs' bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def exact_numerics() -> None:
    """Full-f32 products on the card (cuBLAS and cuDNN both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties to even), still stored as f32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> float8 e4m3 with one scale for the tensor, and back."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _RoundTF32(torch.autograd.Function):
    """TF32 operand: the value rounded, the gradient passed through."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradTF32(torch.autograd.Function):
    """A product's output: the value as is, its incoming gradient rounded
    to TF32 (the backward products' operand)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Prec:
    """Products (matmul, conv) in one of "f32", "tf32", "fp8". The fp8
    control rounds convolutions only: it stands for the CNNs' bfloat16
    step; the graph and GNN are f32 in the configuration, and their
    control is "tf32"."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        exact_numerics()

    def _mm_operand(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundTF32.apply(x) if self.kind == "tf32" else x

    def _product(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGradTF32.apply(y) if self.kind == "tf32" else y

    def _conv_operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "tf32":
            return _RoundTF32.apply(x)
        if self.kind == "fp8":
            return round_fp8(x)
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._product(self._mm_operand(a) @ self._mm_operand(b))

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return self._product(torch.einsum(eq, *(self._mm_operand(o) for o in ops)))

    def conv(self, x, w, stride=1, padding=0, groups=1, bias=None):
        return self._product(F.conv2d(
            self._conv_operand(x), self._conv_operand(w), bias, stride=stride,
            padding=padding, groups=groups))
