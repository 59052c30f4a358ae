"""The two patch CNNs of the pixel path, plain and in f32, read straight
from their flax-layout weight trees (reference/weights.py):

  * KimiaNet: DenseNet-121 features, norm5 without a ReLU, global mean
    pool -> 1024 features a patch (Riasat et al., KimiaNet, 2021; the
    reference repository's extractor);
  * HoVer-Net typing (Graham et al., 2019), 'fast' mode: the
    pre-activation ResNet-50 encoder with TensorFlow 'same' padding, the
    tp decoder of valid convolutions and dense blocks, and a per-patch
    majority vote over the nonzero classes of the per-pixel argmax. The
    reference repository's graph constructor hands HoVer-Net the patch
    with its height and width swapped; so does this.

Input: uint8 NHWC patches, scaled to [0, 1]. Every product goes through
a `Prec`, so the same code is the fp8 control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .precision import Prec

BN_EPS = 1e-5


def _bn(x, p, s):
    if s.get("_calibrate"):
        s["mean"] = x.mean(dim=(0, 2, 3))
        s["var"] = x.var(dim=(0, 2, 3), unbiased=False)
    a = p["scale"] / torch.sqrt(s["var"] + BN_EPS)
    b = p["bias"] - s["mean"] * a
    return x * a[None, :, None, None] + b[None, :, None, None]


def _conv(prec: Prec, x, k, stride=1, padding=0, groups=1, bias=None):
    """x NCHW, k HWIO."""
    return prec.conv(x, k.permute(3, 2, 0, 1), stride, padding, groups, bias)


def _pixels(px: torch.Tensor) -> torch.Tensor:
    return px.to(torch.float32) / 255.0


# ---------------------------------------------------------------------------
# KimiaNet
# ---------------------------------------------------------------------------
def kimianet_features(w: Dict, px: torch.Tensor, prec: Prec) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> features [B, 1024]."""
    p, s = w["params"]["backbone"], w["batch_stats"]["backbone"]
    x = _pixels(px).permute(0, 3, 1, 2)
    x = _conv(prec, x, p["conv0"]["kernel"], stride=2, padding=3)
    x = F.relu(_bn(x, p["norm0"], s["norm0"]))
    x = F.max_pool2d(x, 3, 2, padding=1)
    n_blocks = 4
    bi = 0
    while f"denseblock{bi + 1}_layer1" in p:
        li = 0
        while f"denseblock{bi + 1}_layer{li + 1}" in p:
            name = f"denseblock{bi + 1}_layer{li + 1}"
            lp, ls = p[name], s[name]
            h = _conv(prec, F.relu(_bn(x, lp["norm1"], ls["norm1"])),
                      lp["conv1"]["kernel"])
            h = _conv(prec, F.relu(_bn(h, lp["norm2"], ls["norm2"])),
                      lp["conv2"]["kernel"], padding=1)
            x = torch.cat([x, h], dim=1)
            li += 1
        if bi + 1 < n_blocks:
            t = f"transition{bi + 1}"
            x = _conv(prec, F.relu(_bn(x, p[t]["norm"], s[t]["norm"])),
                      p[t]["conv"]["kernel"])
            x = F.avg_pool2d(x, 2, 2)
        bi += 1
    x = _bn(x, p["norm5"], s["norm5"])
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# HoVer-Net typing
# ---------------------------------------------------------------------------
def _same_pad(x, ksize: int, stride: int):
    """TensorFlow 'same' padding as HoVer-Net's TFSamepaddingLayer pads:
    one (lo, hi) pair from H, on both axes."""
    size = x.shape[2]
    pad = max(ksize - (stride if size % stride == 0 else size % stride), 0)
    lo = pad // 2
    return F.pad(x, (lo, pad - lo, lo, pad - lo))


def _crop(x, ch: int, cw: int):
    t, l = ch // 2, cw // 2
    return x[:, :, t:x.shape[2] - (ch - t), l:x.shape[3] - (cw - l)]


def _bnrelu(x, p, s, name):
    return F.relu(_bn(x, p[name]["bn"], s[name]["bn"]))


def _residual(prec, x, p, s, units: int, stride: int):
    shortcut = _conv(prec, x, p["shortcut"]["kernel"], stride=stride)
    prev = x
    for u in range(units):
        st = stride if u == 0 else 1
        h = prev if u == 0 else _bnrelu(prev, p, s, f"u{u}_preact")
        h = _bnrelu(_conv(prec, h, p[f"u{u}_conv1"]["kernel"]), p, s,
                    f"u{u}_bn1")
        h = _same_pad(h, 3, st)
        h = _bnrelu(_conv(prec, h, p[f"u{u}_conv2"]["kernel"], stride=st),
                    p, s, f"u{u}_bn2")
        h = _conv(prec, h, p[f"u{u}_conv3"]["kernel"])
        prev = h + shortcut
        shortcut = prev
    return _bnrelu(prev, p, s, "blk_bna")


def _dense_block(prec, x, p, s, units: int):
    prev = x
    for u in range(units):
        h = _bnrelu(prev, p, s, f"u{u}_preact")
        h = _bnrelu(_conv(prec, h, p[f"u{u}_conv1"]["kernel"]), p, s,
                    f"u{u}_bn1")
        h = _conv(prec, h, p[f"u{u}_conv2"]["kernel"], groups=4)
        dh, dw = prev.shape[2] - h.shape[2], prev.shape[3] - h.shape[3]
        prev = torch.cat([_crop(prev, dh, dw), h], dim=1)
    return _bnrelu(prev, p, s, "blk_bna")


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def hovernet_tp_logits(w: Dict, px: torch.Tensor, prec: Prec) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> tp logits [B, T, h, w] of the swapped patch."""
    p, s = w["params"], w["batch_stats"]
    x = _pixels(px).transpose(1, 2).permute(0, 3, 1, 2)
    x = _conv(prec, _same_pad(x, 7, 1), p["conv0"]["kernel"])
    x = _bnrelu(x, p, s, "bn0")
    skips = []
    for name, units, stride in (("d0", 3, 1), ("d1", 4, 2), ("d2", 6, 2),
                                ("d3", 3, 2)):
        x = _residual(prec, x, p[name], s[name], units, stride)
        skips.append(x)
    d0, d1, d2, d3 = skips
    d3 = _conv(prec, d3, p["conv_bot"]["kernel"])
    d0, d1 = _crop(d0, 92, 92), _crop(d1, 36, 36)
    q, r = p["decoder_tp"], s["decoder_tp"]
    u3 = _conv(prec, _up(d3) + d2, q["u3_conva"]["kernel"])
    u3 = _dense_block(prec, u3, q["u3_dense"], r["u3_dense"], 8)
    u3 = _conv(prec, u3, q["u3_convf"]["kernel"])
    u2 = _conv(prec, _up(u3) + d1, q["u2_conva"]["kernel"])
    u2 = _dense_block(prec, u2, q["u2_dense"], r["u2_dense"], 4)
    u2 = _conv(prec, u2, q["u2_convf"]["kernel"])
    u1 = _same_pad(_up(u2) + d0, 3, 1)
    u1 = _conv(prec, u1, q["u1_conva"]["kernel"])
    u0 = _bnrelu(u1, q, r, "u0_bn")
    return _conv(prec, u0, q["u0_conv"]["kernel"], bias=q["u0_conv"]["bias"])


def type_votes(tp_logits: torch.Tensor) -> torch.Tensor:
    """[B, T, h, w] logits -> [B, T] count of pixels whose argmax is each
    class."""
    b, t = tp_logits.shape[:2]
    arg = tp_logits.argmax(dim=1).reshape(b, -1)
    votes = torch.zeros(b, t, dtype=torch.int64, device=arg.device)
    return votes.scatter_add_(1, arg, torch.ones_like(arg))


def node_types(votes: torch.Tensor) -> torch.Tensor:
    """The majority nonzero class (ties to the lower class), 0 where no
    pixel votes for a nucleus class."""
    nz = votes[:, 1:]
    return torch.where(nz.sum(1) > 0, nz.argmax(1) + 1, 0)


def featurize(kimia: Dict, hover: Dict, px: torch.Tensor, prec: Prec,
              block: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 patches [B, H, W, 3] on the device -> (features [B, 1024],
    type votes [B, T]), `block` patches at a time."""
    feats, votes = [], []
    with torch.no_grad():
        for i in range(0, px.shape[0], block):
            chunk = px[i:i + block]
            feats.append(kimianet_features(kimia, chunk, prec))
            votes.append(type_votes(hovernet_tp_logits(hover, chunk, prec)))
    return torch.cat(feats), torch.cat(votes)


# ---------------------------------------------------------------------------
# making seeded weights behave as trained ones do
# ---------------------------------------------------------------------------
def _stat_dicts(tree: Dict):
    if "mean" in tree and "var" in tree:
        yield tree
        return
    for v in tree.values():
        if isinstance(v, dict):
            yield from _stat_dicts(v)


def calibrate(kimia: Dict, hover: Dict, px: torch.Tensor) -> None:
    """Fit seeded CNN weights to the patches they will see, in place, as
    training would leave them: every BatchNorm's running mean and variance
    become its input's statistics over `px` (forward order, f32), and
    HoVer-Net's tp head is standardised per class over the pixels of `px`
    (each class's logit mean 0, spread 1), so nucleus types vary from patch
    to patch as a trained head's do. Without this, a random net's features
    differ by ~2% of their norm from patch to patch and one type wins
    every pixel."""
    prec = Prec("f32")
    with torch.no_grad():
        for w, fn in ((kimia, kimianet_features), (hover, hovernet_tp_logits)):
            stats = list(_stat_dicts(w["batch_stats"]))
            for d in stats:
                d["_calibrate"] = True
            try:
                fn(w, px, prec)
            finally:
                for d in stats:
                    d.pop("_calibrate")
        logits = hovernet_tp_logits(hover, px, prec)
        mu = logits.mean(dim=(0, 2, 3))
        sd = logits.std(dim=(0, 2, 3)).clamp_min(1e-6)
        head = hover["params"]["decoder_tp"]["u0_conv"]
        head["kernel"] = (head["kernel"] / sd).contiguous()
        head["bias"] = ((head["bias"] - mu) / sd).contiguous()
