"""Prov-GigaPath's slide encoder, LongNetViT (Xu et al., "A whole-slide
foundation model for digital pathology from real-world data", Nature
2024; github.com/prov-gigapath/prov-gigapath: gigapath/slide_encoder.py's
`gigapath_slide_enc12l768d` and the torchscale LongNet it builds, with
LongNet's DilatedAttention, Ding et al., arXiv:2307.02486), plus a linear
head for fine-tuning. Parameter names are torchscale's and gigapath's,
so the published `slide_encoder.pth` loads as is (`load_slide_encoder`).

One slide: tile embeddings X [N, in_dim] and tile coordinates C [N, 2] in
pixels; T = N + 1 tokens.

  * h = patch_embed.proj(X) + the 2D sin-cos position of each tile: row
    p = ngrids * floor(C0 / tile) + floor(C1 / tile) + 1 of MAE's
    get_2d_sincos_pos_embed(dim, ngrids, cls_token=True), computed for the
    rows needed only (`sincos_rows`);
  * [cls_token + row 0 (zeros), h];
  * `depth` torchscale EncoderLayers, pre-LN with sub-LN:
        h += out_proj(inner_attn_ln(DilatedAttention(self_attn_layer_norm(h))))
        h += fc2(ffn_layernorm(GELU(fc1(final_layer_norm(h)))))
    (GELU with erf; every LayerNorm eps 1e-5);
  * encoder.layer_norm (eps 1e-5), then norm (eps 1e-6), of the CLS row:
    the slide embedding; head: Linear(dim, n_classes).

DilatedAttention, for each pair (w, r) of segment length and dilation
ratio: s = min(w, T); the sequence, zero-padded to a multiple of s, is
cut into segments of s rows, each zero-padded to a multiple of r; head h
of group g = floor(h / (heads / r)) attends over the segment's rows
congruent to g mod r (softmax(q k^T / sqrt(head_dim)) v, with its
log-sum-exp). A row a head did not take reads o = 0 and lse = -1e8 for
that pair. The pairs merge by their log-sum-exps: o = sum_i alpha_i o_i,
alpha = softmax over the pairs of lse_i.

Read from the published code as follows (this module's reading of it):
  * sub-LN: `inner_attn_ln` before out_proj and `ffn_layernorm` before
    fc2, both LayerNorms of the branch's own width;
  * the zero pad rows are keys no mask removes: each adds e^0 to the
    softmax's sum of its segment;
  * alpha is computed without gradient: a constant in the backward pass.

The regrouping is strided views of the projections with one copy per
pair each way (`_Regroup`); the attentions are the flash kernel of
torch's SDPA through the aten op that also returns the log-sum-exp (the
CPU's flash op off the card). Under bf16 autocast the products and the
attention are bf16; the residual stream, the LayerNorms, the log-sum-exps
and the merge stay f32. Each layer's forward DilatedAttention (regrouping,
the attentions and the merge) is the `longnet/attn` span.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import profiling

DILATED_RATIOS = (1, 2, 4, 8, 16)
NO_TAKE_LSE = -1e8     # the log-sum-exp of a row a head did not take


def get_optimal_segment_length(max_wsi_size: int = 262144,
                               tile_size: int = 256) -> List[int]:
    """gigapath's segment lengths: 2^linspace(10, log2(tiles per side^2),
    5), truncated; [1024, 5792, 32768, 185363, 1048576] by default."""
    max_seq_len = (max_wsi_size // tile_size) ** 2
    exps = np.linspace(np.log2(1024), int(np.log2(max_seq_len)), 5)
    return [int(x) for x in np.power(2, exps).astype(int)]


def sincos_table(ngrids: int, dim: int) -> torch.Tensor:
    """[ngrids, dim / 2] f32: [sin(p w), cos(p w)] at grid position p, with
    w_k = 10000^(-k / (dim / 4)); computed in float64 as MAE's numpy is."""
    half = dim // 2
    omega = 1.0 / 10000 ** (np.arange(half // 2, dtype=np.float64) / (half / 2))
    out = np.arange(ngrids, dtype=np.float64)[:, None] * omega[None]
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], 1)
                            .astype(np.float32))


def sincos_rows(table: torch.Tensor, coords: torch.Tensor,
                tile_size: int) -> torch.Tensor:
    """The rows of MAE's 2D table for tile coordinates [N, 2] (pixels):
    the column's half first (C1), then the row's (C0)."""
    grid = torch.div(coords, tile_size, rounding_mode="floor").long()
    return torch.cat([table[grid[:, 1]], table[grid[:, 0]]], 1)


# --------------------------------------------------------------------- #
class _Layout:
    """Where each row of a [T, P, H, D] tensor goes in one pair's sparse
    buffer [P, n_seg, r, H / r, L, D] (SDPA's [batch, heads, rows, dim] per
    P once (r, H / r) is flattened: head g * H / r + h' holds the rows
    l * r + g of each segment). `pairs` gives matching strided views of the
    two: every real row's taken heads, once."""

    def __init__(self, t: int, s: int, r: int, heads: int):
        self.t, self.s, self.r, self.hr = t, s, r, heads // r
        self.n_seg = -(-t // s)
        self.length = -(-s // r)
        # (first segment, segments, real rows in each)
        full = t // s
        self.groups = [(0, full, s)] if full else []
        if t % s:
            self.groups.append((full, 1, t % s))

    def sparse_shape(self, p: int, d: int) -> Tuple[int, ...]:
        return (p, self.n_seg, self.r, self.hr, self.length, d)

    def pairs(self, dense: torch.Tensor, sparse: torch.Tensor):
        """[(dense view, sparse view)] of dense [T, P, H, D] (contiguous)
        and sparse [P, n_seg, r, H / r, L, D]."""
        _, p, h, d = dense.shape
        r, hr, s = self.r, self.hr, self.s
        row = p * h * d
        # (P, segments, g, h', l, d) of the dense rows seg * s + l * r + g
        stride = (h * d, s * row, row + hr * d, d, r * row, 1)
        base = dense.storage_offset()
        out = []
        for seg0, k, c in self.groups:
            for g, l0, nl in ((r, 0, c // r), (c % r, c // r, 1)):
                if g == 0 or nl == 0:
                    continue
                off = base + (seg0 * s + l0 * r) * row
                out.append((dense.as_strided((p, k, g, hr, nl, d), stride, off),
                            sparse[:, seg0:seg0 + k, :g, :, l0:l0 + nl]))
        return out


class _Regroup(torch.autograd.Function):
    """Dense [T, P, H, D] -> one pair's zero-padded sparse buffer, and its
    transpose as the backward (and the other way round: `scatter`)."""

    @staticmethod
    def forward(ctx, x, layout: _Layout, to_sparse: bool):
        ctx.layout, ctx.to_sparse = layout, to_sparse
        return _move(x, layout, to_sparse, 0.0)

    @staticmethod
    def backward(ctx, g):
        return _move(g.contiguous(), ctx.layout, not ctx.to_sparse, 0.0), None, None


def _move(x: torch.Tensor, layout: _Layout, to_sparse: bool,
          fill: float) -> torch.Tensor:
    if to_sparse:
        _, p, _, d = x.shape
        out = x.new_full(layout.sparse_shape(p, d), fill)
        for dv, sv in layout.pairs(x, out):
            sv.copy_(dv)
    else:
        p, d = x.shape[0], x.shape[-1]
        out = x.new_full((layout.t, p, layout.hr * layout.r, d), fill)
        for dv, sv in layout.pairs(out, x):
            dv.copy_(sv)
    return out


def gather(x: torch.Tensor, layout: _Layout) -> torch.Tensor:
    return _Regroup.apply(x.contiguous(), layout, True)


def scatter(x: torch.Tensor, layout: _Layout) -> torch.Tensor:
    return _Regroup.apply(x.contiguous(), layout, False)


def flash_with_lse(q, k, v, scale: float):
    """softmax(q k^T * scale) v and its log-sum-exp [B, H, L] (f32), on
    [B, H, L, D] operands: SDPA's flash kernel on the card (bf16 or fp16
    operands), the CPU's flash op elsewhere. (cuDNN's SDPA is 1.7x
    faster at these shapes, but builds a plan of ~200 ms for each new
    shape, and each slide's length is a new shape.)"""
    if q.is_cuda:
        out = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, False, False, scale=scale)
    else:
        out = torch.ops.aten._scaled_dot_product_flash_attention_for_cpu(
            q, k, v, 0.0, False, scale=scale)
    return out[0], out[1][..., :q.shape[2]]


class DilatedAttention(nn.Module):
    """torchscale's DilatedAttention with sub-LN (`inner_attn_ln`), on one
    sequence [T, dim]."""

    def __init__(self, dim: int, heads: int, segment_lengths: Sequence[int],
                 dilated_ratios: Sequence[int], ln_eps: float = 1e-5):
        super().__init__()
        if len(segment_lengths) != len(dilated_ratios):
            raise ValueError("one dilation ratio per segment length")
        if any(heads % r for r in dilated_ratios):
            raise ValueError(f"{heads} heads do not split into {dilated_ratios}")
        self.heads, self.head_dim = heads, dim // heads
        self.pairs = list(zip(segment_lengths, dilated_ratios))
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.inner_attn_ln = nn.LayerNorm(dim, eps=ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[0]
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight])
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias])
        qkv = F.linear(x, w, b).view(t, 3, self.heads, self.head_dim)
        with profiling.span("longnet/attn", device=x.device):
            o = self.attend(qkv)
        return self.out_proj(self.inner_attn_ln(o))

    def attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """[T, 3, H, D] -> the merged attention [T, H * D] (f32)."""
        t, _, h, d = qkv.shape
        outs, lses = [], []
        for w, r in self.pairs:
            lay = _Layout(t, min(w, t), r, h)
            q, k, v = gather(qkv, lay).flatten(2, 3).unbind(0)
            o, lse = flash_with_lse(q, k, v, 1.0 / math.sqrt(d))
            outs.append(scatter(o.unflatten(1, (r, h // r))[None], lay)[:, 0])
            with torch.no_grad():
                lses.append(_move(lse.unflatten(1, (r, h // r))[None, ..., None],
                                  lay, False, NO_TAKE_LSE)[:, 0, :, 0])
        with torch.no_grad():
            alpha = torch.softmax(torch.stack(lses), 0)
        merged = sum(a[..., None] * o for a, o in zip(alpha, outs))
        return merged.reshape(t, h * d)


class FeedForwardNetwork(nn.Module):
    """torchscale's FFN with sub-LN: fc2(ffn_layernorm(GELU(fc1(x))))."""

    def __init__(self, dim: int, hidden: int, ln_eps: float = 1e-5):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.ffn_layernorm = nn.LayerNorm(hidden, eps=ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.ffn_layernorm(F.gelu(self.fc1(x))))


class EncoderLayer(nn.Module):
    """torchscale's pre-LN EncoderLayer; `dropout` on each branch's output
    and drop path on the branch (training only)."""

    def __init__(self, dim: int, heads: int, hidden: int,
                 segment_lengths, dilated_ratios, dropout: float = 0.0,
                 drop_path: float = 0.0, ln_eps: float = 1e-5):
        super().__init__()
        self.self_attn = DilatedAttention(dim, heads, segment_lengths,
                                          dilated_ratios, ln_eps)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=ln_eps)
        self.ffn = FeedForwardNetwork(dim, hidden, ln_eps)
        self.final_layer_norm = nn.LayerNorm(dim, eps=ln_eps)
        self.dropout, self.drop_path = dropout, drop_path

    def _branch(self, y: torch.Tensor) -> torch.Tensor:
        y = F.dropout(y, self.dropout, self.training)
        if self.training and self.drop_path > 0:
            keep = 1.0 - self.drop_path
            y = y * (torch.rand((), device=y.device) < keep).to(y.dtype) / keep
        return y

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self._branch(self.self_attn(self.self_attn_layer_norm(h)))
        return h + self._branch(self.ffn(self.final_layer_norm(h)))


class _Encoder(nn.Module):
    def __init__(self, layers: List[EncoderLayer], dim: int, ln_eps: float):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.layer_norm = nn.LayerNorm(dim, eps=ln_eps)


class _PatchEmbed(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, dim)


class LongNetViT(nn.Module):
    """gigapath_slide_enc12l768d (by default) and a linear head: one slide's
    tile embeddings [N, in_dim] and coordinates [N, 2] -> logits
    [1, n_classes]."""

    def __init__(self, in_dim: int = 1536, dim: int = 768, depth: int = 12,
                 heads: int = 16, mlp_ratio: float = 4.0, n_classes: int = 2,
                 segment_lengths: Sequence[int] = None,
                 dilated_ratios: Sequence[int] = DILATED_RATIOS,
                 ngrids: int = 1000, tile_size: int = 256,
                 dropout: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        if segment_lengths is None:
            segment_lengths = get_optimal_segment_length()
        self.tile_size, self.ngrids = tile_size, ngrids
        self.patch_embed = _PatchEmbed(in_dim, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        paths = np.linspace(0, drop_path_rate, depth)
        self.encoder = _Encoder(
            [EncoderLayer(dim, heads, int(dim * mlp_ratio), segment_lengths,
                          dilated_ratios, dropout, float(p)) for p in paths],
            dim, 1e-5)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, n_classes)
        self.register_buffer("sincos", sincos_table(ngrids, dim), persistent=False)

    def embed(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """The slide embedding [1, dim]: the CLS row after both norms."""
        h = self.patch_embed.proj(x) + sincos_rows(self.sincos, coords,
                                                   self.tile_size)
        h = torch.cat([self.cls_token[0].to(h.dtype), h])
        for layer in self.encoder.layers:
            h = layer(h)
        return self.norm(self.encoder.layer_norm(h[:1]))

    def forward(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        return self.head(self.embed(x, coords))

    def load_slide_encoder(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The published slide encoder's weights (every key but the head's;
        a `pos_embed` table, which this module computes, is skipped)."""
        sd = {k: v for k, v in state_dict.items() if k != "pos_embed"}
        missing, unexpected = self.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.startswith("head.")]
        if missing or unexpected:
            raise KeyError(f"missing {missing}, unexpected {unexpected}")


def layer_id(name: str, depth: int) -> int:
    """MAE's layer id for layer-wise rate decay: the embedding 0, encoder
    layer i i + 1, the final norms and the head depth + 1."""
    if name.startswith(("cls_token", "patch_embed")):
        return 0
    if name.startswith("encoder.layers."):
        return int(name.split(".")[2]) + 1
    return depth + 1


def param_groups(model: LongNetViT, lr: float, weight_decay: float,
                 layer_decay: float) -> List[Dict]:
    """AdamW's groups, one per layer id and decay: rate lr *
    layer_decay^(depth + 1 - id) (its `lr_scale`), no weight decay on
    biases, norms and the CLS token (MAE's lr_decay)."""
    depth = len(model.encoder.layers)
    groups: Dict[Tuple[int, float], Dict] = {}
    for name, p in model.named_parameters():
        lid = layer_id(name, depth)
        decay = 0.0 if p.ndim == 1 or name == "cls_token" else weight_decay
        scale = layer_decay ** (depth + 1 - lid)
        g = groups.setdefault((lid, decay), {
            "params": [], "lr": lr * scale, "lr_scale": scale,
            "weight_decay": decay})
        g["params"].append(p)
    return list(groups.values())
