"""UNI2-h, plain and in f32, read straight from a timm-layout state dict
(MahmoodLab/UNI2-h's model card: timm's VisionTransformer with
img_size 224, patch_size 14, depth 24, num_heads 24, embed_dim 1536,
mlp_ratio 2.66667 * 2, SwiGLUPacked, SiLU, init_values 1e-5, reg_tokens 8,
no_embed_class, num_classes 0):

  * the tile: uint8 [H, W, 3] / 255, resized to 224 x 224 (bilinear,
    antialiased: torchvision's Resize on a tensor), ImageNet's mean and
    std;
  * patch embedding: a 14 x 14, stride-14 convolution with bias, 3 -> 1536
    (256 tokens), plus pos_embed on those 256 only (no_embed_class), then
    [cls, reg x 8, patches]: 265 tokens;
  * 24 pre-norm blocks: h += ls1 * proj(MHA(LN1(h))), the attention
    written out as softmax(q k^T / 8) v over 24 heads of 64; then
    [a, b] = fc1(LN2(h)) (1536 -> 8192, a the first half, timm's GluMlp
    with gate_last=False), h += ls2 * fc2(SiLU(a) * b) (4096 -> 1536);
  * the CLS row of the final LayerNorm: 1536 features a patch.

Every LayerNorm has eps 1e-6 and is written out. Patches run in slices so
that the f32 activations fit. Imports nothing of the port.

The controls that the cell's `feat_rel_l2` limit is set against
(PERF.md, section 2): `fp8=True` rounds every matrix product's operands
(the patch convolution, the linear maps, q k^T and the attention's
product with v) to float8 e4m3 with one scale per tensor of one patch
(weights: one per tensor), accumulating in f32, the step below the
program's bfloat16; and three faults, `fault=` "skip_last_block",
"no_registers" (the 8 register tokens left out) and "gate_swapped"
(SiLU on fc1's second half).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import FP8_MAX, exact_numerics, round_fp8

UNI2H = {"img_size": 224, "patch_size": 14, "embed_dim": 1536, "depth": 24,
         "num_heads": 24, "mlp_hidden": 8192, "reg_tokens": 8}
LN_EPS = 1e-6
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FAULTS = ("skip_last_block", "no_registers", "gate_swapped")

# Operations a patch needs at UNI2H's sizes, counted by
# torch.utils.flop_counter on `features` (benchmark/tests count it
# again). By hand: 24 blocks x (2 x 265 x 1536 x (4608 + 1536 + 8192 +
# 4096) for qkv, proj, fc1, fc2, plus 2 x 2 x 24 x 265^2 x 64 for q k^T
# and the product with v) + 2 x 256 x 588 x 1536 for the patch
# embedding = 370,940,461,056.
FLOPS_PER_PATCH = 370_940_461_056

Spec = List[Tuple[str, Tuple[int, ...], str]]


def arch_of(config: Dict) -> Dict:
    """The encoder's sizes from a configuration's `encoder` section
    (UNI2H's where it names none)."""
    enc = config.get("encoder", {})
    return {k: int(enc.get(k, v)) for k, v in UNI2H.items()}


def spec(arch: Dict = UNI2H) -> Spec:
    """timm's state dict for these sizes as (name, shape, kind) rows."""
    d, p = arch["embed_dim"], arch["patch_size"]
    hid = arch["mlp_hidden"]
    n_patches = (arch["img_size"] // p) ** 2
    rows: Spec = [("cls_token", (1, 1, d), "token"),
                  ("reg_token", (1, arch["reg_tokens"], d), "token"),
                  ("pos_embed", (1, n_patches, d), "token"),
                  ("patch_embed.proj.weight", (d, 3, p, p), "patch"),
                  ("patch_embed.proj.bias", (d,), "bias")]

    def linear(name, dout, din):
        rows.append((f"{name}.weight", (dout, din), "linear"))
        rows.append((f"{name}.bias", (dout,), "bias"))

    def norm(name):
        rows.append((f"{name}.weight", (d,), "norm"))
        rows.append((f"{name}.bias", (d,), "bias"))

    for i in range(arch["depth"]):
        b = f"blocks.{i}"
        norm(f"{b}.norm1")
        linear(f"{b}.attn.qkv", 3 * d, d)
        linear(f"{b}.attn.proj", d, d)
        rows.append((f"{b}.ls1.gamma", (d,), "gamma"))
        norm(f"{b}.norm2")
        linear(f"{b}.mlp.fc1", hid, d)
        linear(f"{b}.mlp.fc2", d, hid // 2)
        rows.append((f"{b}.ls2.gamma", (d,), "gamma"))
    norm("norm")
    return rows


def make_weights(rows: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} from one normal draw of a generator
    seeded with `seed` on that device:
      * linear: N(0, 1/fan_in); patch: N(0, 1/588), its fan-in;
      * norm: exp(N(0, 0.1^2)), near 1; bias: N(0, 0.05^2);
      * token (cls, reg, pos_embed): N(0, 1), as large as a patch token,
        so that the register tokens take part;
      * gamma (LayerScale): 0.2 exp(N(0, 0.1^2)). The trained init of 1e-5
        would leave every block out of the output at random weights, and
        no check could see a block missing."""
    device = torch.device(device)
    sizes = [math.prod(s) for _, s, _ in rows]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, shape, kind), n in zip(rows, sizes):
        x = flat[off:off + n].reshape(shape)
        off += n
        if kind in ("linear", "patch"):
            x = x * math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind == "norm":
            x = torch.exp(0.1 * x)
        elif kind == "gamma":
            x = 0.2 * torch.exp(0.1 * x)
        elif kind == "bias":
            x = 0.05 * x
        out[name] = x.contiguous()
    return out


def _fp8(x: torch.Tensor, per_patch: bool) -> torch.Tensor:
    """float8 e4m3 and back, one scale per patch (dim 0) or per tensor."""
    if not per_patch:
        return round_fp8(x)
    amax = x.abs().flatten(1).amax(1).reshape((-1,) + (1,) * (x.dim() - 1))
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(x, w, name, fp8: bool):
    a, k = x, w[f"{name}.weight"]
    if fp8:
        a, k = _fp8(a, True), _fp8(k, False)
    return a @ k.T + w[f"{name}.bias"]


def _layer_norm(x, w, name):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * w[f"{name}.weight"]
            + w[f"{name}.bias"])


def _pixels(px: torch.Tensor, img_size: int) -> torch.Tensor:
    x = px.to(torch.float32).permute(0, 3, 1, 2) / 255.0
    if x.shape[-1] != img_size or x.shape[-2] != img_size:
        x = F.interpolate(x, size=(img_size, img_size), mode="bilinear",
                          align_corners=False, antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def _block(h, w, b: str, heads: int, fp8: bool, gate_swapped: bool):
    n, t, d = h.shape
    hd = d // heads
    qkv = _linear(_layer_norm(h, w, f"{b}.norm1"), w, f"{b}.attn.qkv", fp8)
    q, k, v = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    if fp8:
        q, k, v = _fp8(q, True), _fp8(k, True), _fp8(v, True)
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    if fp8:
        attn = _fp8(attn, True)
    o = (attn @ v).transpose(1, 2).reshape(n, t, d)
    h = h + w[f"{b}.ls1.gamma"] * _linear(o, w, f"{b}.attn.proj", fp8)
    u = _linear(_layer_norm(h, w, f"{b}.norm2"), w, f"{b}.mlp.fc1", fp8)
    a, g = u.chunk(2, dim=-1)
    if gate_swapped:
        a, g = g, a
    m = _linear(a * torch.sigmoid(a) * g, w, f"{b}.mlp.fc2", fp8)
    return h + w[f"{b}.ls2.gamma"] * m


def features(w: Dict[str, torch.Tensor], px: torch.Tensor, arch: Dict = UNI2H,
             fp8: bool = False, fault: Optional[str] = None,
             batch: int = 16) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> CLS features [B, embed_dim] f32."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    exact_numerics()
    p, heads = arch["patch_size"], arch["num_heads"]
    depth = arch["depth"] - (fault == "skip_last_block")
    kernel, bias = w["patch_embed.proj.weight"], w["patch_embed.proj.bias"]
    if fp8:
        kernel = _fp8(kernel, False)
    out = []
    with torch.no_grad():
        for s in range(0, px.shape[0], batch):
            x = _pixels(px[s:s + batch], arch["img_size"])
            if fp8:
                x = _fp8(x, True)
            h = F.conv2d(x, kernel, bias, stride=p).flatten(2).transpose(1, 2)
            h = h + w["pos_embed"]
            n = h.shape[0]
            lead = [w["cls_token"].expand(n, -1, -1)]
            if fault != "no_registers":
                lead.append(w["reg_token"].expand(n, -1, -1))
            h = torch.cat(lead + [h], dim=1)
            for i in range(depth):
                h = _block(h, w, f"blocks.{i}", heads, fp8,
                           fault == "gate_swapped")
            out.append(_layer_norm(h[:, 0], w, "norm"))
    return torch.cat(out)


def flops_per_patch(arch: Dict = UNI2H) -> int:
    """torch.utils.flop_counter's count of `features` on one patch, on the
    meta device (no memory, no time)."""
    from torch.utils.flop_counter import FlopCounterMode

    w = {name: torch.empty(shape, device="meta") for name, shape, _ in spec(arch)}
    px = torch.empty((1, 256, 256, 3), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as fc:
        features(w, px, arch)
    return int(fc.get_total_flops())


def hand_flops_per_patch(arch: Dict = UNI2H) -> int:
    """The same count by hand (the module docstring's sum)."""
    d, hid = arch["embed_dim"], arch["mlp_hidden"]
    grid = (arch["img_size"] // arch["patch_size"]) ** 2
    t = grid + 1 + arch["reg_tokens"]
    per_block = (2 * t * d * (3 * d + d + hid + hid // 2)
                 + 2 * 2 * t * t * d)
    return arch["depth"] * per_block + 2 * grid * 3 * arch["patch_size"] ** 2 * d
