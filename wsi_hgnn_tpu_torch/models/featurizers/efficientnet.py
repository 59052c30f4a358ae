"""EfficientNet-B4, the 'efficientnet-b4' featurizer (counterpart of
wsi_hgnn_tpu/models/featurizers/efficientnet.py): efficientnet_pytorch's
compound-scaled B0 (width 1.4, depth 1.8 for B4: 32 MBConv blocks, a
48-channel stem, a 1792-channel head) and a fc head whose output is the
patch feature. Modules run NCHW inside; `efficientnet_apply` takes NHWC
patches.

efficientnet_pytorch pads every convolution with STATIC same padding:
Conv2dStaticSamePadding freezes each conv's pads from the model's native
resolution ladder (380 -> 190 -> 95 -> 48 -> 24 -> 12 for B4), not from
the input it is given. On a 256 input the k=5/s=2 stage-3 depthwise conv
pads (2, 2) where `padding="same"` would pad (1, 2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# B0 block args: (num_repeat, kernel, stride, expand, in_ch, out_ch, se_ratio)
_B0_BLOCKS = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

_SCALES = {  # name -> (width, depth, resolution, dropout)
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
}
BN_EPS = 1e-3   # efficientnet_pytorch's BatchNorm eps (torch's default: 1e-5)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def static_same_pad(ladder: int, kernel: int, stride: int):
    """Conv2dStaticSamePadding's frozen pads for a conv whose feature map
    at the NATIVE input size is `ladder` px. Returns (((lo, hi),) * 2,
    next_ladder), as the JAX function does."""
    pad = max((math.ceil(ladder / stride) - 1) * stride + kernel - ladder, 0)
    lo, hi = pad // 2, pad - pad // 2
    return ((lo, hi), (lo, hi)), math.ceil(ladder / stride)


def _pad(x: torch.Tensor, pads) -> torch.Tensor:
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom))


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


class MBConv(nn.Module):
    """Inverted bottleneck with squeeze-excite. The SE width comes from the
    block's INPUT channels; the residual applies at stride 1 with
    in == out (drop-connect is off in eval)."""

    def __init__(self, in_ch: int, kernel: int, stride: int, expand: int,
                 out_ch: int, se_ratio: float, ladder: int):
        super().__init__()
        self.expand, self.stride = expand, stride
        self.residual = stride == 1 and in_ch == out_ch
        self.dw_pad, _ = static_same_pad(ladder, kernel, stride)
        ch = in_ch * expand
        if expand != 1:
            self.expand_conv = nn.Conv2d(in_ch, ch, 1, bias=False)
            self.bn0 = _bn(ch)
        self.depthwise_conv = nn.Conv2d(ch, ch, kernel, stride=stride,
                                        groups=ch, bias=False)
        self.bn1 = _bn(ch)
        self.se = se_ratio > 0
        if self.se:
            se_ch = max(1, int(in_ch * se_ratio))
            self.se_reduce = nn.Conv2d(ch, se_ch, 1)
            self.se_expand = nn.Conv2d(se_ch, ch, 1)
        self.project_conv = nn.Conv2d(ch, out_ch, 1, bias=False)
        self.bn2 = _bn(out_ch)

    def forward(self, x):
        h = x
        if self.expand != 1:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = F.silu(self.bn1(self.depthwise_conv(_pad(h, self.dw_pad))))
        if self.se:
            s = h.mean(dim=(2, 3), keepdim=True)
            s = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(s))))
            h = h * s
        h = self.bn2(self.project_conv(h))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """efficientnet_pytorch's backbone and fc head (num_classes outputs)."""

    def __init__(self, width: float = 1.4, depth: float = 1.8,
                 num_classes: int = 1024, dropout: float = 0.4,
                 native_size: int = 380):
        super().__init__()
        self.dropout = dropout
        self.stem_pad, ladder = static_same_pad(native_size, 3, 2)
        ch = round_filters(32, width)
        self.conv_stem = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.bn_stem = _bn(ch)
        idx = 0
        for (r, k, s, e, _, co, se) in _B0_BLOCKS:
            co = round_filters(co, width)
            for j in range(round_repeats(r, depth)):
                stride = s if j == 0 else 1
                self.add_module(f"block{idx}", MBConv(ch, k, stride, e, co,
                                                      se, ladder))
                ladder = math.ceil(ladder / stride)
                ch = co
                idx += 1
        self.n_blocks = idx
        head = round_filters(1280, width)
        self.conv_head = nn.Conv2d(ch, head, 1, bias=False)
        self.bn_head = _bn(head)
        self.fc = nn.Linear(head, num_classes)

    @classmethod
    def from_name(cls, name: str, num_classes: int = 1024) -> "EfficientNet":
        if name not in _SCALES:
            raise NotImplementedError(f"EfficientNet {name!r} is not built "
                                      f"(known: {sorted(_SCALES)})")
        w, d, res, drop = _SCALES[name]
        return cls(width=w, depth=d, num_classes=num_classes, dropout=drop,
                   native_size=res)

    def forward(self, x):
        """NCHW pixels -> [B, num_classes]."""
        x = F.silu(self.bn_stem(self.conv_stem(_pad(x, self.stem_pad))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.bn_head(self.conv_head(x)))
        x = F.dropout(x.mean(dim=(2, 3)), self.dropout, self.training)
        return self.fc(x)


def efficientnet_apply(model: EfficientNet, imgs: torch.Tensor
                       ) -> torch.Tensor:
    """NHWC pixels [B, H, W, 3] -> features [B, num_classes] f32, the patch
    as it is (no H/W swap, unlike HoVer-Net)."""
    x = imgs.permute(0, 3, 1, 2)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    return model(x).float()
