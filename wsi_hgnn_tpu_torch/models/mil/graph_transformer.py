"""GTNMIL's GraphTransformer (counterpart of wsi_hgnn_tpu/models/mil/
graph_transformer.py): one masked dense GCN block over the padded bag's
dense adjacency, a soft assignment of nodes to a fixed number of clusters
pooled with the mincut objective (its mincut and orthogonality losses
returned), a cls token, a small ViT encoder.

Kept from the reference: the embedding normalised by rsqrt(sum y^2 +
1e-12) (a norm would have a NaN gradient at the zero padding rows);
LayerNorm eps 1e-6 in the blocks and 1e-5 in the final norm; qkv without
bias; exact-erf GELU; the cls token initialised to zeros; the mincut and
orthogonality losses with Frobenius norms floored at 1e-12; the pooled
adjacency with its diagonal zeroed and degree-normalised. The GCN
block's BatchNorm is the zoo's MaskedBatchNorm (flax momentum 0.9, the
unbiased variance): batch statistics in training, running ones in eval.

`graphcam` is the reference's GraphCAM: the transformer-LRP relevance of
relprop.py over the cluster tokens, mapped back to the nodes through the
softmaxed assignment matrix.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import MaskedBatchNorm


class GCNBlock(nn.Module):
    """Dense masked GCN layer: adj @ x (+ x), a linear map, per-node
    embedding normalisation, masked BatchNorm, optional ReLU, the mask.
    x [B, N, D], adj [B, N, N], mask [B, N]."""

    def __init__(self, in_dim: int, features: int, add_self: bool = True,
                 normalize_embedding: bool = True, use_bn: bool = True,
                 relu: bool = False):
        super().__init__()
        self.add_self, self.normalize_embedding = add_self, normalize_embedding
        self.relu = relu
        self.weight = nn.Linear(in_dim, features)
        self.bn = MaskedBatchNorm(features) if use_bn else None

    def forward(self, x, adj, mask):
        y = torch.matmul(adj, x)
        if self.add_self:
            y = y + x
        y = self.weight(y)
        if self.normalize_embedding:
            y = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-12)
        if self.bn is not None:
            y = self.bn(y, mask.bool())
        if self.relu:
            y = F.relu(y)
        return y * mask.to(y.dtype)[:, :, None]


def dense_mincut_pool(x, adj, s, mask):
    """torch_geometric's dense_mincut_pool: (x', adj', mincut_loss,
    ortho_loss)."""
    s = torch.softmax(s, -1) * mask.to(s.dtype)[:, :, None]
    x_pool = torch.einsum("bnk,bnd->bkd", s, x)
    adj_pool = torch.einsum("bnk,bnm,bml->bkl", s, adj, s)

    num = torch.diagonal(adj_pool, dim1=-2, dim2=-1).sum(-1)
    deg = adj.sum(-1)
    denom = torch.einsum("bnk,bn,bnk->b", s, deg, s)
    mincut = -(num / denom.clamp_min(1e-12)).mean()

    ss = torch.einsum("bnk,bnl->bkl", s, s)
    k = s.shape[-1]
    eye = torch.eye(k, dtype=s.dtype, device=s.device)
    ss_norm = torch.linalg.norm(ss, dim=(-1, -2), keepdim=True)
    ortho = torch.linalg.norm(ss / ss_norm.clamp_min(1e-12)
                              - eye / math.sqrt(k), dim=(-1, -2)).mean()

    d = torch.diagonal(adj_pool, dim1=-2, dim2=-1)
    adj_pool = adj_pool - d[:, :, None] * eye
    inv = torch.rsqrt(adj_pool.sum(-1).clamp_min(1e-12))
    adj_pool = adj_pool * inv[:, :, None] * inv[:, None, :]
    return x_pool, adj_pool, mincut, ortho


class TransformerBlock(nn.Module):
    """The reference ViT block: pre-norm attention with a bias-free fused
    qkv, scale head_dim**-0.5, then a pre-norm 2x GELU MLP."""

    def __init__(self, dim: int, heads: int = 8, mlp_ratio: float = 2.0):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        b, n, _ = x.shape
        hd = self.dim // self.heads
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, self.heads, hd
                                               ).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5, -1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, self.dim)
        x = x + self.proj(out)
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + h


class GraphTransformer(nn.Module):
    """The GTNMIL classifier: forward(node_feat [B, N, D], adj [B, N, N],
    mask [B, N]) -> (logits [B, n_class], mincut + ortho loss)."""

    def __init__(self, n_class: int, in_dim: int = 1024, embed_dim: int = 64,
                 node_cluster_num: int = 100, depth: int = 3):
        super().__init__()
        self.embed_dim = embed_dim
        self.conv1 = GCNBlock(in_dim, embed_dim)
        self.pool1 = nn.Linear(embed_dim, node_cluster_num)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}", TransformerBlock(embed_dim))
        self.depth = depth
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.head = nn.Linear(embed_dim, n_class)

    def forward(self, node_feat, adj, mask) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        x = mask.to(node_feat.dtype)[:, :, None] * node_feat
        x = self.conv1(x, adj, mask)
        s = self.pool1(x)
        x, _, mc1, o1 = dense_mincut_pool(x, adj, s, mask)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], 1)
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        logits = self.head(self.norm(x)[:, 0])
        return logits, mc1 + o1


@torch.no_grad()
def graphcam(model: GraphTransformer, node_feat, adj, mask, class_idx: int,
             method: str = "transformer_attribution") -> torch.Tensor:
    """Per-node GraphCAM relevance [N] for `class_idx` of the first bag:
    the pooled cluster tokens recomputed (conv1 with its running batch
    statistics, pool1, dense_mincut_pool), `vit_relprop` over [cls,
    clusters], then softmax(s) * mask @ cam."""
    from .relprop import vit_relprop

    was_training = model.training
    model.eval()
    try:
        x = mask.to(node_feat.dtype)[:, :, None] * node_feat
        x = model.conv1(x, adj, mask)
        s = model.pool1(x)
        x_pool = dense_mincut_pool(x, adj, s, mask)[0]
        tokens = torch.cat([model.cls_token, x_pool[:1]], 1)
        cam_cluster = vit_relprop(model, tokens, class_idx, method=method)
    finally:
        model.train(was_training)
    s_soft = torch.softmax(s, -1)[0] * mask[0].to(s.dtype)[:, None]
    return s_soft @ cam_cluster
