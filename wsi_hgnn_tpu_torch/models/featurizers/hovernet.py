"""HoVer-Net (counterpart of wsi_hgnn_tpu/models/featurizers/hovernet.py):
the pre-activation ResNet50 encoder with TF 'same' padding quirks, the
tp/np/hv decoder branches of valid convolutions and dense blocks, and the
repo's fc1 bottleneck feature over the 32x32x1024 encoder output. Modules
run NCHW inside; the public functions take NHWC patches, as the JAX
package's do.

Two uses: nucleus typing (encoder + tp branch + a per-patch majority vote,
`HoVerNet.typing` builds the net without np/hv and fc1) and the 'hover'
encoder (`hovernet_full_apply`: typing plus the fc1 features).

Every BatchNorm + ReLU is one pass (`kernels.bn_act`: the hand-written
kernel on the card, the plain ops on the CPU), and each residual sum is
made in the pass of the BatchNorm that reads it. Where TF 'same' padding
is symmetric (every stride-1 convolution: (k-1)/2 on each side whatever
the size) the convolution pads itself and no padded copy is made; only
the three stride-2 units pad with `tf_same_pad`.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.hovernet import bn_act


def tf_same_pad(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """TFSamepaddingLayer on NCHW: the same (lo, hi) on H and W, from H.
    Asymmetric where the pad is odd, which torch's padding=k//2 is not."""
    size = x.shape[2]
    if size % stride == 0:
        pad = max(ksize - stride, 0)
    else:
        pad = max(ksize - (size % stride), 0)
    lo = pad // 2
    return F.pad(x, (lo, pad - lo, lo, pad - lo))


def crop_op(x: torch.Tensor, cropping) -> torch.Tensor:
    """Centre crop of NCHW by a subtracted amount."""
    ct = cropping[0] // 2
    cb = cropping[0] - ct
    cl = cropping[1] // 2
    cr = cropping[1] - cl
    return x[:, :, ct:x.shape[2] - cb, cl:x.shape[3] - cr]


def crop_to_shape(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return crop_op(x, (x.shape[2] - y.shape[2], x.shape[3] - y.shape[3]))


def _conv(cin, cout, k, stride=1, groups=1, bias=False, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias=bias)


def _same_conv(cin, cout, k, stride):
    """A k x k convolution with TF 'same' padding: at stride 1 the pad is
    (k-1)/2 on both sides, the convolution's own; at stride 2 the caller
    pads with tf_same_pad."""
    return _conv(cin, cout, k, stride, padding=(k - 1) // 2 if stride == 1
                 else 0)


class BNRelu(nn.Module):
    """relu(bn(x)); with `residual`, relu(bn(x + residual)), and the sum
    too when keep_sum ((s, y)): one pass either way (kernels.bn_act)."""

    def __init__(self, ch: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(ch, eps=1e-5)

    def forward(self, x, residual=None, keep_sum: bool = False):
        return bn_act(x, self.bn, residual, keep_sum)


class ResidualBlock(nn.Module):
    """Pre-activation bottleneck stack; the stride acts in the first unit
    and the shortcut."""

    def __init__(self, in_ch: int, unit_ch, unit_count: int, stride: int = 1):
        super().__init__()
        c1, c2, c3 = unit_ch
        self.unit_count, self.stride = unit_count, stride
        self.shortcut = (_conv(in_ch, c3, 1, stride)
                         if in_ch != c3 or stride != 1 else None)
        for idx in range(unit_count):
            cin = in_ch if idx == 0 else c3
            if idx != 0:  # the first unit has no pre-activation
                self.add_module(f"u{idx}_preact", BNRelu(cin))
            self.add_module(f"u{idx}_conv1", _conv(cin, c1, 1))
            self.add_module(f"u{idx}_bn1", BNRelu(c1))
            self.add_module(f"u{idx}_conv2",
                            _same_conv(c1, c2, 3, stride if idx == 0 else 1))
            self.add_module(f"u{idx}_bn2", BNRelu(c2))
            self.add_module(f"u{idx}_conv3", _conv(c2, c3, 1))
        self.blk_bna = BNRelu(c3)

    def forward(self, x):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        h = x
        for idx in range(self.unit_count):
            u = lambda name: getattr(self, f"u{idx}_{name}")  # noqa: E731
            if idx:   # the unit's input, the next shortcut, and its preact
                shortcut, h = u("preact")(h, shortcut, keep_sum=True)
            h = u("bn1")(u("conv1")(h))
            if idx == 0 and self.stride != 1:
                h = tf_same_pad(h, 3, self.stride)
            h = u("conv3")(u("bn2")(u("conv2")(h)))
        return self.blk_bna(h, shortcut)


class DenseBlock(nn.Module):
    """Valid-conv dense block: each unit shrinks H and W by ksize-1 and the
    running concat is centre-cropped to match; conv2 is grouped (split 4)."""

    def __init__(self, in_ch: int, unit_ch, ksize: int, unit_count: int,
                 split: int = 4):
        super().__init__()
        self.unit_count = unit_count
        ch = in_ch
        for idx in range(unit_count):
            self.add_module(f"u{idx}_preact", BNRelu(ch))
            self.add_module(f"u{idx}_conv1", _conv(ch, unit_ch[0], 1))
            self.add_module(f"u{idx}_bn1", BNRelu(unit_ch[0]))
            self.add_module(f"u{idx}_conv2",
                            _conv(unit_ch[0], unit_ch[1], ksize, groups=split))
            ch += unit_ch[1]
        self.blk_bna = BNRelu(ch)

    def forward(self, x):
        prev = x
        for idx in range(self.unit_count):
            u = lambda name: getattr(self, f"u{idx}_{name}")  # noqa: E731
            h = u("conv2")(u("bn1")(u("conv1")(u("preact")(prev))))
            prev = torch.cat([crop_to_shape(prev, h), h], dim=1)
        return self.blk_bna(prev)


def _upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DecoderBranch(nn.Module):
    """One tp/np/hv decoder branch."""

    def __init__(self, out_ch: int, ksize: int):
        super().__init__()
        k = ksize
        self.u3_conva = _conv(1024, 256, k)
        self.u3_dense = DenseBlock(256, (128, 32), k, 8)
        self.u3_convf = _conv(512, 512, 1)
        self.u2_conva = _conv(512, 128, k)
        self.u2_dense = DenseBlock(128, (128, 32), k, 4)
        self.u2_convf = _conv(256, 256, 1)
        self.u1_conva = _same_conv(256, 64, k, 1)
        self.u0_bn = BNRelu(64)
        self.u0_conv = _conv(64, out_ch, 1, bias=True)

    def forward(self, d):
        d0, d1, d2, d3 = d
        u3 = self.u3_convf(self.u3_dense(self.u3_conva(_upsample2x(d3) + d2)))
        u2 = self.u2_convf(self.u2_dense(self.u2_conva(_upsample2x(u3) + d1)))
        u1 = self.u1_conva(_upsample2x(u2) + d0)
        return self.u0_conv(self.u0_bn(u1))


class ChunkedDense(nn.Module):
    """fc1: a dense layer whose kernel is kept in flax's [K, F] layout (the
    JAX module's name and parameter tree; it scans K in chunks to keep its
    program small, which the one product here does not need). At K =
    32*32*1024 and F = 1024 the kernel is 4.3 GB in f32."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return torch.addmm(self.bias, x, self.kernel)

    @torch.no_grad()
    def seed_(self, seed: int) -> "ChunkedDense":
        """flax's init (lecun-normal kernel, zero bias), drawn on the
        kernel's own device: a generator there, so a 4 GB kernel is never
        made on the host. Devices draw different streams from one seed."""
        from ...convert import trunc_normal

        gen = torch.Generator(device=self.kernel.device).manual_seed(seed)
        self.kernel.copy_(trunc_normal(
            self.kernel.shape, math.sqrt(1.0 / self.kernel.shape[0]), gen))
        self.bias.zero_()
        return self


BRANCHES = ("tp", "np", "hv")
FC1_IN = 32 * 32 * 1024   # the 32x32x1024 bottleneck of a 256x256 patch


class HoVerNet(nn.Module):
    """HoVer-Net ('fast' mode expects 256x256): encoder, the decoders in
    `branches` (tp has nr_types channels, np and hv 2 each), and fc1 over
    the NHWC-flattened bottleneck when with_fc1."""

    def __init__(self, nr_types: int = 6, mode: str = "fast",
                 feat_dim: int = 1024, with_fc1: bool = True,
                 branches: Sequence[str] = BRANCHES):
        super().__init__()
        if mode not in ("original", "fast"):
            raise ValueError(f"unknown HoVer-Net mode {mode!r}")
        self.nr_types, self.mode = nr_types, mode
        self.branches = tuple(branches)
        # 'fast' pads the 256 px input TF-same (3 a side), 'original' not
        self.conv0 = _conv(3, 64, 7, padding=3 if mode == "fast" else 0)
        self.bn0 = BNRelu(64)
        self.d0 = ResidualBlock(64, (64, 64, 256), 3, stride=1)
        self.d1 = ResidualBlock(256, (128, 128, 512), 4, stride=2)
        self.d2 = ResidualBlock(512, (256, 256, 1024), 6, stride=2)
        self.d3 = ResidualBlock(1024, (512, 512, 2048), 3, stride=2)
        self.conv_bot = _conv(2048, 1024, 1)
        ksize = 5 if mode == "original" else 3
        for name in self.branches:
            self.add_module(f"decoder_{name}", DecoderBranch(
                nr_types if name == "tp" else 2, ksize))
        self.fc1 = ChunkedDense(FC1_IN, feat_dim) if with_fc1 else None

    @classmethod
    def typing(cls, nr_types: int = 6, mode: str = "fast") -> "HoVerNet":
        """The typing net: encoder and tp branch only."""
        return cls(nr_types, mode, with_fc1=False, branches=("tp",))

    def encode(self, imgs):
        """NCHW pixels -> the cropped skips (d0, d1, d2, d3)."""
        x = self.bn0(self.conv0(imgs))
        d0 = self.d0(x)
        d1 = self.d1(d0)
        d2 = self.d2(d1)
        d3 = self.conv_bot(self.d3(d2))
        if self.mode == "original":
            return crop_op(d0, (184, 184)), crop_op(d1, (72, 72)), d2, d3
        return crop_op(d0, (92, 92)), crop_op(d1, (36, 36)), d2, d3

    def decode_branch(self, name: str, d):
        return getattr(self, f"decoder_{name}")(d)

    def feature_head(self, d3):
        """fc1 over d3 [B, 1024, 32, 32] flattened NHWC, as the JAX module
        flattens it (the reference's torch weight is over the NCHW
        flatten; convert.py reorders its columns)."""
        return self.fc1(d3.permute(0, 2, 3, 1).reshape(d3.shape[0], -1))

    def forward(self, imgs):
        """NCHW pixels -> ({branch: NCHW map}, fc1 features | None)."""
        d = self.encode(imgs)
        out = {name: self.decode_branch(name, d) for name in self.branches}
        return out, (self.feature_head(d[3]) if self.fc1 is not None
                     else None)


def node_types_from_tp(tp_map: np.ndarray, nr_types: int = 6) -> np.ndarray:
    """Host twin of node_types_on_device over [B, H, W, T] logits: the
    majority NONZERO class of the argmax map, 0 with no nucleus pixel."""
    types = np.asarray(tp_map).argmax(axis=-1)
    out = np.zeros(types.shape[0], np.int32)
    for i, t in enumerate(types):
        nz = t[t != 0]
        out[i] = 0 if nz.size == 0 else int(
            np.bincount(nz, minlength=nr_types).argmax())
    return out


def node_types_on_device(tp_logits: torch.Tensor, nr_types: int = 6
                         ) -> torch.Tensor:
    """[B, H, W, T] type logits -> [B] int32 node types: the majority
    NONZERO class of the argmax map, ties to the lowest class, 0 for a
    patch with no nucleus pixel."""
    t = tp_logits.argmax(dim=-1).reshape(tp_logits.shape[0], -1)
    counts = torch.zeros(t.shape[0], nr_types, dtype=torch.int64,
                         device=t.device)
    counts.scatter_add_(1, t, torch.ones_like(t))
    nz = counts[:, 1:]
    has_nucleus = nz.sum(dim=-1) > 0
    return torch.where(has_nucleus, nz.argmax(dim=-1) + 1, 0).to(torch.int32)


def _constructor_orientation(imgs: torch.Tensor) -> torch.Tensor:
    """The reference constructor feeds HoVer-Net the spatially TRANSPOSED
    patch (its two permutes compose to an H/W swap), and the net is not
    transpose-equivariant: NHWC -> NWHC."""
    return imgs.transpose(1, 2)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW, channels-last in memory on the card (cuDNN's fast
    layout)."""
    x = x.permute(0, 3, 1, 2)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def hovernet_typing_apply(model: HoVerNet, imgs: torch.Tensor,
                          nr_types: int = 6) -> torch.Tensor:
    """NHWC pixels [B, 256, 256, 3] -> node types [B] int32: encoder, tp
    decoder and the on-device majority vote, on the constructor's
    transposed orientation."""
    d = model.encode(_nchw(_constructor_orientation(imgs)))
    tp = model.decode_branch("tp", d)
    return node_types_on_device(tp.permute(0, 2, 3, 1), nr_types)


def hovernet_full_apply(model: HoVerNet, imgs: torch.Tensor,
                        nr_types: int = 6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 'hover' encoder: NHWC pixels [B, 256, 256, 3] -> (fc1 features
    [B, feat_dim] f32, node types [B] int32), both from the constructor's
    transposed orientation; np/hv are not run."""
    d = model.encode(_nchw(_constructor_orientation(imgs)))
    tp = model.decode_branch("tp", d)
    feats = model.feature_head(d[3]).float()
    return feats, node_types_on_device(tp.permute(0, 2, 3, 1), nr_types)
