"""UNI2-h, the 'uni2-h' featurizer: a ViT-H/14 pathology encoder with
SwiGLU MLPs and 8 register tokens (MahmoodLab/UNI2-h's model card; the
successor of UNI, Chen et al., Nature Medicine 2024). The JAX package has
no counterpart.

The card builds it through timm's VisionTransformer with img_size 224,
patch_size 14, depth 24, num_heads 24, embed_dim 1536, mlp_ratio
2.66667 * 2 (SwiGLUPacked: fc1 1536 -> 8192, fc2 4096 -> 1536), SiLU,
init_values 1e-5, reg_tokens 8, no_embed_class, num_classes 0. For a
normalised image x [B, 3, 224, 224]:

    h = patch_embed(x) + pos_embed          14x14/14 conv: 256 tokens
    h = [cls, reg x 8, h]                   265 tokens
    per block:
        h += ls1 * proj(MHA(LN1(h)))        24 heads of 64, softmax(qk^T/8)v
        a, b = fc1(LN2(h)).chunk(2)         a the first half
        h += ls2 * fc2(SiLU(a) * b)
    feature = LN(h)[:, 0]                   the CLS row, 1536 wide

Every LayerNorm has eps 1e-6. Submodule and parameter names are timm's
(`blocks.{i}.attn.qkv.weight`, `blocks.{i}.ls1.gamma`, `reg_token`, ...),
so a timm state dict loads as it is. On the card the weights are bf16:
torch's bf16 products (f32 accumulation), LayerNorm and softmax
statistics in f32, `scaled_dot_product_attention` (flash at head width
64). The residual stream h stays f32, as under torch.autocast: each
update adds the bf16 branch times its LayerScale into it, and each
LayerNorm reads it rounded to bf16 (a bf16 stream doubles the features'
error over 24 blocks). f32 throughout on the CPU.

Launch order: the GEMMs are `nn.Linear`'s and the attention SDPA's; the
passes between them are `kernels.vit` (csrc/vit_block.cu on the card,
the unfused ops on the CPU). After the token concat, `add_layer_norm`
without a branch gives block 0's LN1. Each block then runs

    attn(y) -> add_layer_norm(h, ls1, ., norm2)       h updated, y = LN2(h)
    fc1(y) -> swiglu -> fc2 -> add_layer_norm(h, ls2, ., next LN1)

where the next LN1 is the next block's norm1, and none after the last
block, whose second update runs alone. A chunk makes 24 `swiglu` and
1 + 24 x 2 = 49 `add_layer_norm` launches, then the final LayerNorm of
the CLS rows in f32. The stream is updated in place: the ViT runs frozen,
under `torch.inference_mode()`.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.vit import add_layer_norm, swiglu

# the model card's timm settings, as this module's keyword arguments
UNI2H = dict(img_size=224, patch_size=14, embed_dim=1536, depth=24,
             num_heads=24, mlp_hidden=8192, reg_tokens=8)
LN_EPS = 1e-6
INIT_VALUES = 1e-5        # LayerScale's init (timm's init_values)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, t, d))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), INIT_VALUES))


class GluMlp(nn.Module):
    """timm's GluMlp with gate_last=False (SwiGLUPacked): SiLU of fc1's
    first half times its second half."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(swiglu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = GluMlp(dim, mlp_hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                next_norm: Optional[nn.LayerNorm]) -> Optional[torch.Tensor]:
        """x: the f32 residual stream, updated in place; y: norm1 of it,
        in the weights' dtype. Returns next_norm of the updated stream
        (None when next_norm is None)."""
        y = add_layer_norm(x, self.ls1.gamma, self.attn(y), self.norm2)
        return add_layer_norm(x, self.ls2.gamma, self.mlp(y), next_norm)


class ViT(nn.Module):
    """The UNI2-h encoder (UNI2H's sizes by default): a normalised image
    [B, 3, img_size, img_size] -> its CLS feature [B, embed_dim] f32."""

    def __init__(self, img_size: int = 224, patch_size: int = 14,
                 embed_dim: int = 1536, depth: int = 24, num_heads: int = 24,
                 mlp_hidden: int = 8192, reg_tokens: int = 8):
        super().__init__()
        self.img_size = img_size
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.reg_token = nn.Parameter(torch.zeros(1, reg_tokens, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_hidden)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x in the weights' dtype -> f32 features."""
        h = self.patch_embed.proj(x).flatten(2).transpose(1, 2).float()
        # no_embed_class: the position embedding is added to the patch
        # tokens only, then [cls, reg x 8, patches]
        h = h + self.pos_embed.float()
        b = h.shape[0]
        h = torch.cat([self.cls_token.float().expand(b, -1, -1),
                       self.reg_token.float().expand(b, -1, -1), h], dim=1)
        blocks = list(self.blocks)
        y = add_layer_norm(h, None, None, blocks[0].norm1) if blocks else None
        for blk, nxt in zip(blocks, blocks[1:] + [None]):
            y = blk(h, y, None if nxt is None else nxt.norm1)
        # the final LayerNorm of the CLS row alone, in f32
        return F.layer_norm(h[:, 0], self.norm.normalized_shape,
                            self.norm.weight.float(), self.norm.bias.float(),
                            self.norm.eps)


def seed_(model: ViT, seed: int) -> ViT:
    """timm's init, drawn on the model's device, in place: Linear weights
    and pos_embed truncated-normal with std 0.02, Linear biases 0,
    cls_token and reg_token normal with std 1e-6, the patch conv torch's
    default (uniform within 1/sqrt(fan_in)), LayerNorm 1 and 0, LayerScale
    INIT_VALUES."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    bound = 1.0 / math.sqrt(model.patch_embed.proj.weight[0].numel())
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("patch_embed."):
                p.uniform_(-bound, bound, generator=gen)
            elif name in ("cls_token", "reg_token"):
                p.normal_(0.0, 1e-6, generator=gen)
            elif name == "pos_embed" or (leaf == "weight" and p.ndim == 2):
                nn.init.trunc_normal_(p, std=0.02, generator=gen)
            elif leaf == "gamma":
                p.fill_(INIT_VALUES)
            else:   # Linear biases 0; LayerNorm weight 1, bias 0
                p.fill_(1.0 if leaf == "weight" else 0.0)
    return model


def make_vit(device: torch.device, dtype: torch.dtype = torch.float32,
             state_dict: Optional[Dict] = None, path=None, seed: int = 0,
             **sizes) -> ViT:
    """The encoder on `device` in `dtype`, in eval mode (UNI2H's sizes
    unless `sizes` say otherwise). Weights: `state_dict` (timm layout,
    numpy arrays or tensors) when given; else the timm state dict at
    `path` when that file exists; else the seeded init (`seed_`). Prints
    which weights ran, as the CNNs' loader does."""
    from .convert import load_torch_state_dict

    with torch.device("meta"):
        model = ViT(**{**UNI2H, **sizes})
    if state_dict is None and path and os.path.exists(str(path)):
        state_dict = load_torch_state_dict(path)
        print(f"uni2-h weights: {path}", flush=True)
    elif state_dict is None:
        why = f"{path} not found" if path else "no weights path set"
        print(f"uni2-h weights: seeded init (seed {seed}), {why}", flush=True)
        return seed_(model.to_empty(device=device), seed).to(dtype).eval()
    model.load_state_dict(
        {k: torch.as_tensor(v).to(device=device, dtype=dtype, copy=True)
         for k, v in state_dict.items()}, strict=True, assign=True)
    return model.eval()


def preprocess(imgs: torch.Tensor, img_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Patches [B, H, W, 3] f32 in [0, 1] -> the encoder's input [B, 3,
    img_size, img_size] in `dtype`: a bilinear, antialiased resize
    (torchvision's Resize on a tensor) and ImageNet's mean and std, in
    f32 on the patches' device."""
    x = imgs.permute(0, 3, 1, 2).float()
    if x.shape[-1] != img_size or x.shape[-2] != img_size:
        x = F.interpolate(x, size=(img_size, img_size), mode="bilinear",
                          align_corners=False, antialias=True)
    mean = x.new_tensor(IMAGENET_MEAN)[None, :, None, None]
    std = x.new_tensor(IMAGENET_STD)[None, :, None, None]
    return ((x - mean) / std).to(dtype)


def vit_apply(model: ViT, imgs: torch.Tensor) -> torch.Tensor:
    """Patches [B, H, W, 3] f32 in [0, 1] -> CLS features [B, D] f32."""
    dtype = next(model.parameters()).dtype
    return model(preprocess(imgs, model.img_size, dtype))
