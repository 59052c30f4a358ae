"""EfficientNetV2 (counterpart of wsi_hgnn_tpu/models/featurizers/
effnetv2.py): the from-scratch variant the reference ships beside its
featurizers, unused by every shipped config. Fused-MBConv in the early
stages (no SE), SE-MBConv later; the s/m/l/xl stage tables. NCHW inside;
BatchNorm at flax's defaults (eps 1e-5).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SELayer(nn.Module):
    """Squeeze-excite over `ch` channels, its width from the block input
    `inp`."""

    def __init__(self, inp: int, ch: int):
        super().__init__()
        mid = _make_divisible(inp // 4, 8)
        self.fc1 = nn.Linear(ch, mid)
        self.fc2 = nn.Linear(mid, ch)

    def forward(self, x):
        y = F.silu(self.fc1(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(y))[:, :, None, None]


class MBConvV2(nn.Module):
    def __init__(self, inp: int, out_ch: int, stride: int, expand: int,
                 use_se: bool):
        super().__init__()
        hidden = round(inp * expand)
        self.use_se = use_se
        self.identity = stride == 1 and inp == out_ch
        if use_se:
            self.pw = nn.Conv2d(inp, hidden, 1, bias=False)
            self.bn0 = nn.BatchNorm2d(hidden)
            self.dw = nn.Conv2d(hidden, hidden, 3, stride=stride, padding=1,
                                groups=hidden, bias=False)
            self.bn1 = nn.BatchNorm2d(hidden)
            self.se = SELayer(inp, hidden)
            self.pw_linear = nn.Conv2d(hidden, out_ch, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(out_ch)
        else:
            self.fused = nn.Conv2d(inp, hidden, 3, stride=stride, padding=1,
                                   bias=False)
            self.bn0 = nn.BatchNorm2d(hidden)
            self.pw_linear = nn.Conv2d(hidden, out_ch, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        if self.use_se:
            h = F.silu(self.bn0(self.pw(x)))
            h = F.silu(self.bn1(self.dw(h)))
            h = self.bn2(self.pw_linear(self.se(h)))
        else:
            h = F.silu(self.bn0(self.fused(x)))
            h = self.bn1(self.pw_linear(h))
        return x + h if self.identity else h


# (expand, channels, repeats, stride, use_se) per stage
_CFGS = {
    "s": [(1, 24, 2, 1, 0), (4, 48, 4, 2, 0), (4, 64, 4, 2, 0),
          (4, 128, 6, 2, 1), (6, 160, 9, 1, 1), (6, 256, 15, 2, 1)],
    "m": [(1, 24, 3, 1, 0), (4, 48, 5, 2, 0), (4, 80, 5, 2, 0),
          (4, 160, 7, 2, 1), (6, 176, 14, 1, 1), (6, 304, 18, 2, 1),
          (6, 512, 5, 1, 1)],
    "l": [(1, 32, 4, 1, 0), (4, 64, 7, 2, 0), (4, 96, 7, 2, 0),
          (4, 192, 10, 2, 1), (6, 224, 19, 1, 1), (6, 384, 25, 2, 1),
          (6, 640, 7, 1, 1)],
    "xl": [(1, 32, 4, 1, 0), (4, 64, 8, 2, 0), (4, 96, 8, 2, 0),
           (4, 192, 16, 2, 1), (6, 256, 24, 1, 1), (6, 512, 32, 2, 1),
           (6, 640, 8, 1, 1)],
}


class EffNetV2(nn.Module):
    def __init__(self, cfgs: Sequence[Tuple[int, int, int, int, int]],
                 num_classes: int = 1000, width_mult: float = 1.0):
        super().__init__()
        ch = _make_divisible(24 * width_mult, 8)
        self.stem = nn.Conv2d(3, ch, 3, stride=2, padding=1, bias=False)
        self.bn_stem = nn.BatchNorm2d(ch)
        idx = 0
        for (t, c, n, s, use_se) in cfgs:
            out_ch = _make_divisible(c * width_mult, 8)
            for i in range(n):
                self.add_module(f"block{idx}", MBConvV2(
                    ch, out_ch, s if i == 0 else 1, t, bool(use_se)))
                ch = out_ch
                idx += 1
        self.n_blocks = idx
        head = (_make_divisible(1792 * width_mult, 8) if width_mult > 1.0
                else 1792)
        self.conv_head = nn.Conv2d(ch, head, 1, bias=False)
        self.bn_head = nn.BatchNorm2d(head)
        self.classifier = nn.Linear(head, num_classes)

    @classmethod
    def s(cls, num_classes=1000):
        return cls(_CFGS["s"], num_classes)

    @classmethod
    def m(cls, num_classes=1000):
        return cls(_CFGS["m"], num_classes)

    @classmethod
    def l(cls, num_classes=1000):  # noqa: E743 (the JAX package's name)
        return cls(_CFGS["l"], num_classes)

    @classmethod
    def xl(cls, num_classes=1000):
        return cls(_CFGS["xl"], num_classes)

    def forward(self, x):
        """NCHW pixels -> [B, num_classes]."""
        x = F.silu(self.bn_stem(self.stem(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.bn_head(self.conv_head(x)))
        return self.classifier(x.mean(dim=(2, 3)))
