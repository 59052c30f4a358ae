"""DenseNet-121 dense layer and transition: the hand-written CUDA kernels
and their plain PyTorch versions.

Counterparts of wsi_hgnn_tpu/ops/pallas_densenet.py::dense_layer_fused and
::transition_fused. The kernels (`csrc/dense_layer.cu`,
`csrc/transition.cu`) work on NHWC block buffers with f32 accumulation,
on the tensor cores in both storage types. bf16 (the serving path):
`mma.sync.aligned.m16n8k16` with operands staged by 16-byte `cp.async`;
the dense layer computes the bottleneck once per in-image halo pixel of a
whole-image (H <= 16) or 16x16 tile and the 3x3 conv as an implicit GEMM
over the halo; the transition multiplies the unpooled pixels and pools
the accumulators. On the H100 the dense layer is bound by operations at
H=64 and by bytes from H=16 down, the transition by bytes. f32 (SimCLR's
frozen KimiaNet and `--extract`): full-f32 products in 3xTF32 on
`mma.sync.aligned.m16n8k8` (each operand split into TF32 hi and lo,
lo*hi + hi*lo + hi*hi), 16x8 dense-layer tiles, the transition pooled
first; bound by operations at 3xTF32 but for the first two transitions
(bytes). The kernel sources' notes give the designs and figures. Each
GEMM operand is rounded to the storage type first, as the TPU kernels
do; the TPU kernel's extra rounding of the 3x3 conv's tap products
(pallas_densenet.py:72) is not copied, so bf16 comparisons with the JAX
package allow for it. Operands on the card must be contiguous and
16-byte aligned.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

GROWTH = 32
GROUP = 128
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm inference -> affine: a = scale/sqrt(var+eps), b = bias - mean*a."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick for the kernels on the card)
# ---------------------------------------------------------------------------
def dense_layer_reference(x_full, a1, b1, w1f, b2, w2cat, *,
                          n_active_groups: int, slot: int) -> torch.Tensor:
    """One dense layer on the written prefix of x_full [B, H, W, C_end],
    writing channels [slot*32, slot*32+32) IN PLACE; returns x_full.
    a1/b1 [1, C_end] f32, w1f [C_end, 128], b2 [1, 128] f32,
    w2cat [128, 288] (conv2 as [in, tap*32 + out], tap = 3*di + dj)."""
    k_in = _check_layer(x_full, n_active_groups, slot)
    dt = x_full.dtype
    x = x_full[..., :k_in].float()
    u = torch.relu(x * a1[0, :k_in] + b1[0, :k_in]).to(dt).float()
    v = torch.relu(u @ w1f[:k_in].float() + b2[0]).to(dt).float()
    w2 = w2cat.float().reshape(GROUP, 3, 3, GROWTH).permute(3, 0, 1, 2)
    y = F.conv2d(v.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    x_full[..., k_in:k_in + GROWTH] = y.to(dt)
    return x_full


def transition_reference(x, a, b, w, out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """relu(a*x + b) @ w, then a 2x2/2 average pool, pooled first (the pool
    is linear). x [B, H, W, C], a/b [1, C] f32, w [C, C/2]; returns
    [B, H/2, W/2, C/2], or writes it into out[..., :C/2] and returns out."""
    dt = x.dtype
    h2, w2 = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    u = torch.relu(x[:, :h2, :w2].float() * a[0] + b[0]).to(dt).float()
    s = u[:, 0::2, 0::2] + u[:, 0::2, 1::2]
    s = s + u[:, 1::2, 0::2]
    s = s + u[:, 1::2, 1::2]
    y = ((0.25 * s) @ w.float()).to(dt)
    if out is None:
        return y
    out[..., :y.shape[-1]] = y
    return out


def _check_layer(x_full, n_active_groups: int, slot: int) -> int:
    c_end = x_full.shape[-1]
    k_in = slot * GROWTH
    if not (0 < k_in and k_in + GROWTH <= c_end
            and 0 < n_active_groups and n_active_groups * GROUP >= k_in):
        raise ValueError(f"slot {slot} / {n_active_groups} active groups "
                         f"do not fit a {c_end}-channel block buffer")
    return k_in


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel(name: str, suffix: str):
    fn = getattr(_build.load(name), f"{name}_{suffix}")
    if name == "dense_layer":
        fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    else:
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn


def occupancy(name: str, dtype: torch.dtype) -> tuple[int, int]:
    """(blocks per SM, shared memory bytes per block) of the kernel of
    `name` ("dense_layer" or "transition") for storage `dtype` (bf16 or
    f32, the main path's instantiation), as the CUDA runtime reports them
    on the current card."""
    fn = getattr(_build.load(name), f"{name}_{_DTYPES[dtype]}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(ctypes.byref(blocks), ctypes.byref(smem)),
                 f"{name} occupancy")
    return blocks.value, smem.value


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _cuda_args(x: torch.Tensor, floats, typed) -> str:
    """Validate a launch's operands; returns the dtype suffix."""
    _require(x.device.type == "cuda", "kernel operands must be CUDA tensors")
    _require(x.dtype in _DTYPES, f"unsupported storage dtype {x.dtype}")
    for t in (x, *floats, *typed):
        _require(t.device == x.device and t.is_contiguous()
                 and t.data_ptr() % 16 == 0,
                 "operands must be contiguous, 16-byte aligned and on one "
                 "device")
    for t in floats:
        _require(t.dtype == torch.float32, "affine operands must be f32")
    for t in typed:
        _require(t.dtype == x.dtype, "weights must match the storage dtype")
    return _DTYPES[x.dtype]


def dense_layer_fused(x_full, a1, b1, w1f, b2, w2cat, *,
                      n_active_groups: int, slot: int) -> torch.Tensor:
    """One dense layer, in place on x_full (see dense_layer_reference for
    the operands). A CUDA tensor launches csrc/dense_layer.cu; a CPU
    tensor runs the plain version."""
    if x_full.device.type == "cpu":
        return dense_layer_reference(x_full, a1, b1, w1f, b2, w2cat,
                                     n_active_groups=n_active_groups,
                                     slot=slot)
    suffix = _cuda_args(x_full, (a1, b1, b2), (w1f, w2cat))
    bsz, h, w, c_end = x_full.shape
    k_in = _check_layer(x_full, n_active_groups, slot)
    _require(a1.numel() == c_end and b1.numel() == c_end
             and w1f.shape == (c_end, GROUP) and b2.numel() == GROUP
             and w2cat.shape == (GROUP, 9 * GROWTH), "operand shapes")
    _require(suffix == "f32" or c_end % 8 == 0,
             "the bf16 kernel copies 16-byte rows: C_end % 8 == 0")
    status = _kernel("dense_layer", suffix)(
        x_full.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1f.data_ptr(),
        b2.data_ptr(), w2cat.data_ptr(), bsz, h, w, c_end, k_in, slot,
        torch.cuda.current_stream(x_full.device).cuda_stream)
    _build.check(status, "dense_layer")
    dense_layer_fused.launches += 1
    return x_full


def transition_fused(x, a, b, w, out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """DenseNet transition (see transition_reference). With `out`, the
    result goes into out[..., :C/2] (the next block's zero-padded buffer)
    and out is returned. A CUDA tensor launches csrc/transition.cu; a CPU
    tensor runs the plain version."""
    if x.device.type == "cpu":
        return transition_reference(x, a, b, w, out)
    bsz, h, w_sp, c = x.shape
    if out is None:
        out = torch.empty((bsz, h // 2, w_sp // 2, c // 2), dtype=x.dtype,
                          device=x.device)
    suffix = _cuda_args(x, (a, b), (w, out))
    _require(c % 2 == 0 and a.numel() == c and b.numel() == c
             and w.shape == (c, c // 2)
             and out.shape[:3] == (bsz, h // 2, w_sp // 2)
             and out.shape[3] >= c // 2, "operand shapes")
    _require(suffix == "f32" or (c % 32 == 0 and out.shape[3] % 2 == 0),
             "the bf16 kernel takes 32-channel chunks and stores channel "
             "pairs: C % 32 == 0 and an even out row")
    status = _kernel("transition", suffix)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
        out.data_ptr(), bsz, h, w_sp, c, out.shape[3],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "transition")
    transition_fused.launches += 1
    return out


dense_layer_fused.launches = 0
transition_fused.launches = 0
