"""DenseNet-121 + KimiaNet head (counterpart of
wsi_hgnn_tpu/models/featurizers/densenet.py).

`KimiaNet` is the unfused module, kept for parity with the flax model.
`fuse_kimianet` + `kimianet_fused_apply` are the production path: BN
folded into affines, each dense layer and transition one hand-written
kernel (kernels/densenet.py) over NHWC block buffers, the concat replaced
by in-place slot writes. KimiaNet's wrapper has NO ReLU between norm5 and
the global average pool; both paths keep that.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.densenet import dense_layer_fused, fold_bn, transition_fused

BLOCK_CONFIG = (6, 12, 24, 16)
GROWTH = 32


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth_rate: int = 32, bn_size: int = 4):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = nn.BatchNorm2d(in_ch, eps=1e-5)
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(mid, eps=1e-5)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_ch, eps=1e-5)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet121(nn.Module):
    """torchvision densenet121 features (blocks 6/12/24/16, growth 32,
    init 64), NCHW, ending in norm5 with no ReLU."""

    def __init__(self, block_config=BLOCK_CONFIG, growth_rate: int = GROWTH,
                 num_init_features: int = 64):
        super().__init__()
        self.block_config = tuple(block_config)
        self.conv0 = nn.Conv2d(3, num_init_features, 7, stride=2, padding=3,
                               bias=False)
        self.norm0 = nn.BatchNorm2d(num_init_features, eps=1e-5)
        ch = num_init_features
        for bi, n_layers in enumerate(self.block_config):
            for li in range(n_layers):
                self.add_module(f"denseblock{bi + 1}_layer{li + 1}",
                                DenseLayer(ch, growth_rate))
                ch += growth_rate
            if bi != len(self.block_config) - 1:
                self.add_module(f"transition{bi + 1}", Transition(ch, ch // 2))
                ch //= 2
        self.norm5 = nn.BatchNorm2d(ch, eps=1e-5)
        self.out_ch = ch

    def forward(self, x):
        x = F.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for bi, n_layers in enumerate(self.block_config):
            for li in range(n_layers):
                x = getattr(self, f"denseblock{bi + 1}_layer{li + 1}")(x)
            if bi != len(self.block_config) - 1:
                x = getattr(self, f"transition{bi + 1}")(x)
        return self.norm5(x)  # no ReLU: the KimiaNet path


class KimiaNet(nn.Module):
    """DenseNet121 features -> global average pool -> (out_1 [B, 1024],
    out_3 [B, 512]). Input NHWC, as the flax model takes it."""

    def __init__(self, num_classes: int = 512):
        super().__init__()
        self.backbone = DenseNet121()
        self.fc_4 = nn.Linear(self.backbone.out_ch, num_classes)

    def forward(self, x):
        pooled = self.backbone(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        return pooled, self.fc_4(pooled)


# ---------------------------------------------------------------------------
# fused inference path
# ---------------------------------------------------------------------------
def fuse_kimianet(variables: Dict, dtype: torch.dtype = torch.bfloat16,
                  device="cpu") -> Dict:
    """flax KimiaNet variables (numpy, params + batch_stats) -> fused
    inference operands: BN folded to f32 affines, norm2's scale folded
    into conv1's kernel, conv2 as the tap-major [128, 288] matrix, every
    per-layer array zero-padded to its block's final width."""
    p = variables["params"]["backbone"]
    s = variables["batch_stats"]["backbone"]

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def affine(pp, ss):
        return fold_bn(f32(pp["scale"]), f32(pp["bias"]), f32(ss["mean"]),
                       f32(ss["var"]))

    conv0 = np.asarray(p["conv0"]["kernel"], np.float32).transpose(3, 2, 0, 1)
    fp = {
        "conv0": f32(conv0).to(dtype),
        "fc4_w": f32(variables["params"]["fc_4"]["kernel"]).to(dtype),
        "fc4_b": f32(variables["params"]["fc_4"]["bias"]),
        "blocks": [],
    }
    fp["stem_a"], fp["stem_b"] = affine(p["norm0"], s["norm0"])
    fp["norm5_a"], fp["norm5_b"] = affine(p["norm5"], s["norm5"])

    ch = 64
    for bi, n_layers in enumerate(BLOCK_CONFIG):
        c_end = ch + GROWTH * n_layers
        block = {"layers": []}
        for li in range(n_layers):
            name = f"denseblock{bi + 1}_layer{li + 1}"
            lp, ls = p[name], s[name]
            c_cur = ch + GROWTH * li
            a1, b1 = affine(lp["norm1"], ls["norm1"])
            a2, b2 = affine(lp["norm2"], ls["norm2"])
            w1 = f32(lp["conv1"]["kernel"])[0, 0]                 # [C_cur, 128]
            w1f = torch.zeros(c_end, 128, dtype=dtype, device=device)
            w1f[:c_cur] = (w1 * a2[None, :]).to(dtype)
            w2 = f32(lp["conv2"]["kernel"])                       # [3, 3, 128, 32]
            pad = torch.zeros(c_end - c_cur, device=device)
            block["layers"].append({
                "a1": torch.cat([a1, pad])[None],
                "b1": torch.cat([b1, pad])[None],
                "w1f": w1f,
                "b2": b2[None].contiguous(),
                "w2cat": w2.permute(2, 0, 1, 3).reshape(128, 288)
                           .to(dtype).contiguous(),
            })
        ch = c_end
        if bi != len(BLOCK_CONFIG) - 1:
            name = f"transition{bi + 1}"
            a, b = affine(p[name]["norm"], s[name]["norm"])
            block["trans_a"], block["trans_b"] = a[None], b[None]
            block["trans_w"] = f32(p[name]["conv"]["kernel"])[0, 0].to(dtype
                                                                         ).contiguous()
            ch //= 2
        fp["blocks"].append(block)
    return fp


def kimianet_fused_apply(fp: Dict, pixels: torch.Tensor):
    """(out_1 [B, 1024] f32, out_3 [B, 512]): the fused twin of
    KimiaNet.forward. pixels [B, H, W, 3] NHWC in the storage dtype of fp.
    The 7x7/2 stem and the 3x3/2 max-pool (padded with -inf) stay torch
    ops; every dense layer and transition is one kernel launch."""
    dtype = pixels.dtype
    x = F.conv2d(pixels.permute(0, 3, 1, 2), fp["conv0"], stride=2, padding=3)
    x = torch.relu(x.float() * fp["stem_a"][:, None, None]
                   + fp["stem_b"][:, None, None]).to(dtype)
    x = F.max_pool2d(x, 3, 2, padding=1).permute(0, 2, 3, 1)   # NHWC view

    ch = 64
    bsz, h, w, _ = x.shape
    buf = torch.zeros(bsz, h, w, ch + GROWTH * BLOCK_CONFIG[0], dtype=dtype,
                      device=x.device)
    buf[..., :ch] = x
    for bi, n_layers in enumerate(BLOCK_CONFIG):
        block = fp["blocks"][bi]
        for li in range(n_layers):
            c_cur = ch + GROWTH * li
            lp = block["layers"][li]
            dense_layer_fused(buf, lp["a1"], lp["b1"], lp["w1f"], lp["b2"],
                              lp["w2cat"], n_active_groups=-(-c_cur // 128),
                              slot=c_cur // GROWTH)
        ch = buf.shape[-1]
        if bi != len(BLOCK_CONFIG) - 1:
            ch //= 2
            # the transition writes straight into the next block's
            # zero-padded buffer: no concat copy follows
            nxt = torch.zeros(bsz, buf.shape[1] // 2, buf.shape[2] // 2,
                              ch + GROWTH * BLOCK_CONFIG[bi + 1], dtype=dtype,
                              device=buf.device)
            buf = transition_fused(buf, block["trans_a"], block["trans_b"],
                                   block["trans_w"], out=nxt)

    feat = buf.float() * fp["norm5_a"] + fp["norm5_b"]  # no ReLU
    out_1 = feat.mean(dim=(1, 2))
    out_3 = out_1.to(dtype) @ fp["fc4_w"] + fp["fc4_b"]
    return out_1, out_3
