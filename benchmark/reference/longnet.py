"""Prov-GigaPath's slide encoder (LongNetViT, gigapath_slide_enc12l768d)
with a linear head, and its first fine-tuning steps, plain and in f32
(TF32 off), read straight from a state dict with the published names
(gigapath/slide_encoder.py and its torchscale LongNet; Xu et al., Nature
2024; LongNet's dilated attention, Ding et al., arXiv:2307.02486):

  * h = patch_embed.proj(X) + MAE's 2D sin-cos row of each tile
    (p = 1000 floor(C0 / 256) + floor(C1 / 256) + 1, computed here in
    float64 from the formula: entries 0..dim/2-1 are [sin(j w), cos(j w)]
    of the column j = floor(C1 / 256), the rest the same of the row i,
    w_k = 10000^(-k / (dim / 4)));
  * [cls_token, h] (row 0 of the table is zeros), then `depth` pre-LN
    layers with sub-LN:
        h += out_proj(inner_attn_ln(dilated(q, k, v of self_attn_layer_norm(h))))
        h += fc2(ffn_layernorm(GELU(fc1(final_layer_norm(h)))))
  * encoder.layer_norm, norm, the CLS row; head: Linear(dim, classes); CE.

Dilated attention, written out: for each (w, r), s = min(w, T); the
sequence is zero-padded to whole segments of s rows, each zero-padded to
a multiple of r; head h of group g = h // (heads / r) takes the rows
l r + g of each segment; softmax(q k^T / sqrt(head_dim)) over them, its
log-sum-exp beside it; a row a head did not take has o = 0 and
lse = -1e8; the pairs merge as sum_i alpha_i o_i with alpha the softmax
of the lse_i over the pairs. As the published code is read here: the pad
rows are zero keys no mask removes (each adds e^0 to the softmax's sum),
and alpha is a constant of the backward pass (no gradient).

Every LayerNorm, the GELU (erf), the softmax and the log-softmax are
written out; so is AdamW (torch's decoupled rule) with MAE's layer-wise
rate decay: rate lr * decay^(depth + 1 - id), id 0 for the CLS token and
patch_embed, i + 1 for encoder layer i, depth + 1 for the final norms and
the head; no weight decay on 1-D parameters and the CLS token.

To fit the card at 32768 tiles: each layer is recomputed in the backward
pass (torch.utils.checkpoint), and each attention runs in blocks of query
rows, recomputed too; the same arithmetic. Imports nothing of the port.

The controls the cell's limits are set against (PERF.md, section 2):
`fp8=True` rounds every product's operands to float8 e4m3 (one scale per
tensor) and its incoming gradient to e5m2, the step below the program's
bf16; the faults (`fault=`) "heads_offset0" (every head group takes the
rows at offset 0), "mean_merge" (the pairs averaged), "skip_last_layer";
and `mask_pads=True`, the pad rows masked out of the softmax, another
reading of the published code.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .precision import exact_numerics, round_fp8

ARCH = {"in_dim": 1536, "dim": 768, "depth": 12, "heads": 16,
        "mlp_hidden": 3072, "n_classes": 2,
        "segment_lengths": [1024, 5792, 32768, 185363, 1048576],
        "dilated_ratios": [1, 2, 4, 8, 16], "ngrids": 1000, "tile_size": 256}
FAULTS = ("heads_offset0", "mean_merge", "skip_last_layer")
LN_EPS, NORM_EPS = 1e-5, 1e-6
NO_TAKE = -1e8
BLOCK_ELEMS = 1 << 26     # scores held at once by one attention block
BETAS, EPS = (0.9, 0.999), 1e-8

Spec = List[Tuple[str, Tuple[int, ...], str]]


def arch_of(config: Dict) -> Dict:
    """The model's sizes from a configuration's `model` section."""
    m = config.get("model", {})
    return {k: (list(m[k]) if isinstance(v, list) else int(m[k])) if k in m else v
            for k, v in ARCH.items()}


def spec(arch: Dict = ARCH) -> Spec:
    """The state dict (published names, and the head) as (name, shape,
    kind) rows."""
    d, hid = arch["dim"], arch["mlp_hidden"]
    rows: Spec = [("cls_token", (1, 1, d), "token")]

    def linear(name, dout, din):
        rows.append((f"{name}.weight", (dout, din), "linear"))
        rows.append((f"{name}.bias", (dout,), "bias"))

    def norm(name, n=d):
        rows.append((f"{name}.weight", (n,), "norm"))
        rows.append((f"{name}.bias", (n,), "bias"))

    linear("patch_embed.proj", d, arch["in_dim"])
    for i in range(arch["depth"]):
        b = f"encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{b}.self_attn.{p}", d, d)
        norm(f"{b}.self_attn.inner_attn_ln")
        norm(f"{b}.self_attn_layer_norm")
        linear(f"{b}.ffn.fc1", hid, d)
        linear(f"{b}.ffn.fc2", d, hid)
        norm(f"{b}.ffn.ffn_layernorm", hid)
        norm(f"{b}.final_layer_norm")
    norm("encoder.layer_norm")
    norm("norm")
    rows.append(("head.weight", (arch["n_classes"], d), "head"))
    rows.append(("head.bias", (arch["n_classes"],), "bias"))
    return rows


def make_weights(rows: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} from one normal draw of a generator
    seeded with `seed` on that device: linear N(0, 1/fan_in), norm
    exp(N(0, 0.1^2)), bias N(0, 0.05^2), the CLS token N(0, 1) (as large
    as a tile's embedding), the head N(0, (2e-5)^2) as MAE's fine-tuning
    starts a head: AdamW's first steps at 2e-3 then move the logits by
    about the head's own update (2e-3 |z|_1, about 1.2 a step), and the
    first losses stay away from 0, where a relative loss gap means
    nothing."""
    device = torch.device(device)
    sizes = [math.prod(s) for _, s, _ in rows]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, shape, kind), n in zip(rows, sizes):
        x = flat[off:off + n].reshape(shape)
        off += n
        if kind == "linear":
            x = x * math.sqrt(1.0 / shape[1])
        elif kind == "head":
            x = 2e-5 * x
        elif kind == "norm":
            x = torch.exp(0.1 * x)
        elif kind == "bias":
            x = 0.05 * x
        out[name] = x.contiguous()
    return out


# --------------------------------------------------------------------- #
# products: f32, or the fp8 control
class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        amax = g.abs().amax()
        scale = torch.where(amax > 0, amax / 57344.0, torch.ones_like(amax))
        return (g / scale).to(torch.float8_e5m2).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if not fp8:
        return a @ b
    return _Fp8Grad.apply(_Fp8Operand.apply(a) @ _Fp8Operand.apply(b))


def _linear(x, w, name, fp8):
    return _mm(x, w[f"{name}.weight"].T, fp8) + w[f"{name}.bias"]


def _layer_norm(x, w, name, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * w[f"{name}.weight"]
            + w[f"{name}.bias"])


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


# --------------------------------------------------------------------- #
def position_rows(coords: torch.Tensor, arch: Dict) -> torch.Tensor:
    """[N, dim] f32: each tile's row of MAE's 2D sin-cos table."""
    d4 = arch["dim"] // 4
    omega = 1.0 / 10000 ** (torch.arange(d4, dtype=torch.float64,
                                         device=coords.device) / d4)
    grid = torch.div(coords.to(torch.int64), arch["tile_size"],
                     rounding_mode="floor").to(torch.float64)
    i, j = grid[:, 0:1] * omega, grid[:, 1:2] * omega
    return torch.cat([torch.sin(j), torch.cos(j), torch.sin(i), torch.cos(i)],
                     1).to(torch.float32)


def _geometry(t: int, w: int, r: int) -> Tuple[int, int, int]:
    s = min(w, t)
    return s, -(-t // s), -(-s // r)


def _to_segments(x: torch.Tensor, t: int, w: int, r: int, heads: int,
                 offset0: bool) -> torch.Tensor:
    """[T, H, E] -> [n_seg, H, L, E]: each head's rows of each segment."""
    s, n_seg, length = _geometry(t, w, r)
    e = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n_seg * s - t))
    xp = torch.nn.functional.pad(xp.reshape(n_seg, s, heads, e),
                                 (0, 0, 0, 0, 0, length * r - s))
    xp = xp.reshape(n_seg, length, r, r, heads // r, e)  # rows (l, off), heads (g, h')
    picked = (xp[:, :, 0] if offset0
              else torch.diagonal(xp, dim1=2, dim2=3).permute(0, 1, 4, 2, 3))
    return picked.permute(0, 2, 3, 1, 4).reshape(n_seg, heads, length, e)


def _from_segments(y: torch.Tensor, t: int, w: int, r: int, heads: int,
                   offset0: bool, fill: float) -> torch.Tensor:
    """The inverse: [n_seg, H, L, E] -> [T, H, E], `fill` where a head did
    not take the row (diag_embed's layout)."""
    s, n_seg, length = _geometry(t, w, r)
    e = y.shape[-1]
    y = y.reshape(n_seg, r, heads // r, length, e).permute(0, 3, 1, 2, 4)
    take = torch.zeros(r, r, dtype=y.dtype, device=y.device)   # (off, g)
    if offset0:
        take[0] = 1
    else:
        take.fill_diagonal_(1)
    take = take[None, None, :, :, None, None]
    full = y[:, :, None] * take + (1 - take) * fill
    full = full.reshape(n_seg, length * r, heads, e)[:, :s]
    return full.reshape(n_seg * s, heads, e)[:t]


def _block(q, k, v, valid, scale, fp8):
    """softmax(q k^T scale) v over one block of query rows, written out,
    and the log-sum-exp."""
    s = _mm(q, k.transpose(-1, -2), fp8) * scale
    if valid is not None:
        s = s.masked_fill(~valid[:, :, None, :], -1e30)
    m = s.amax(-1, keepdim=True).detach()
    e = torch.exp(s - m)
    z = e.sum(-1, keepdim=True)
    o = _mm(e / z, v, fp8)
    return o, (m + torch.log(z))[..., 0]


def dilated_attention(q, k, v, arch: Dict, fault: Optional[str] = None,
                      fp8: bool = False, mask_pads: bool = False):
    """q, k, v [T, H, hd] -> the merged attention [T, H * hd]."""
    t, heads, hd = q.shape
    offset0 = fault == "heads_offset0"
    outs, lses = [], []
    for w, r in zip(arch["segment_lengths"], arch["dilated_ratios"]):
        qs, ks, vs = (_to_segments(x, t, w, r, heads, offset0) for x in (q, k, v))
        valid = None
        if mask_pads:
            ids = torch.arange(1, t + 1, dtype=q.dtype, device=q.device)
            ids = ids[:, None, None].expand(t, heads, 1)
            valid = _to_segments(ids, t, w, r, heads, offset0)[..., 0] > 0
        n_seg, _, length, _ = qs.shape
        rows = max(1, BLOCK_ELEMS // (n_seg * heads * length))
        parts = [checkpoint(_block, qs[:, :, b:b + rows], ks, vs, valid,
                            1.0 / math.sqrt(hd), fp8, use_reentrant=False)
                 for b in range(0, length, rows)]
        o = torch.cat([p[0] for p in parts], 2)
        lse = torch.cat([p[1] for p in parts], 2)
        outs.append(_from_segments(o, t, w, r, heads, offset0, 0.0))
        lses.append(_from_segments(lse.detach()[..., None], t, w, r, heads,
                                   offset0, NO_TAKE)[..., 0])
    if fault == "mean_merge":
        out = sum(outs) / len(outs)
    else:
        alpha = torch.softmax(torch.stack(lses), 0)
        out = sum(a[..., None] * o for a, o in zip(alpha, outs))
    return out.reshape(t, heads * hd)


def _layer(h, w, i, arch, fault, fp8, mask_pads):
    b = f"encoder.layers.{i}"
    heads = arch["heads"]
    t, d = h.shape
    a = _layer_norm(h, w, f"{b}.self_attn_layer_norm", LN_EPS)
    q, k, v = (_linear(a, w, f"{b}.self_attn.{p}", fp8).reshape(t, heads, d // heads)
               for p in ("q_proj", "k_proj", "v_proj"))
    o = dilated_attention(q, k, v, arch, fault, fp8, mask_pads)
    o = _layer_norm(o, w, f"{b}.self_attn.inner_attn_ln", LN_EPS)
    h = h + _linear(o, w, f"{b}.self_attn.out_proj", fp8)
    u = _gelu(_linear(_layer_norm(h, w, f"{b}.final_layer_norm", LN_EPS),
                      w, f"{b}.ffn.fc1", fp8))
    u = _layer_norm(u, w, f"{b}.ffn.ffn_layernorm", LN_EPS)
    return h + _linear(u, w, f"{b}.ffn.fc2", fp8)


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor, coords: torch.Tensor,
           arch: Dict = ARCH, fault: Optional[str] = None, fp8: bool = False,
           mask_pads: bool = False) -> torch.Tensor:
    """One slide: tile embeddings [N, in_dim] and coordinates [N, 2] ->
    logits [1, n_classes]."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    exact_numerics()
    h = _linear(x, w, "patch_embed.proj", fp8) + position_rows(coords, arch)
    h = torch.cat([w["cls_token"][0], h])
    depth = arch["depth"] - (fault == "skip_last_layer")
    for i in range(depth):
        if torch.is_grad_enabled():
            h = checkpoint(_layer, h, w, i, arch, fault, fp8, mask_pads,
                           use_reentrant=False)
        else:
            h = _layer(h, w, i, arch, fault, fp8, mask_pads)
    z = _layer_norm(_layer_norm(h[:1], w, "encoder.layer_norm", LN_EPS),
                    w, "norm", NORM_EPS)
    return _linear(z, w, "head", fp8)


def cross_entropy(lg: torch.Tensor, label: int) -> torch.Tensor:
    m = lg.max().detach()
    return m + torch.log(torch.exp(lg - m).sum()) - lg[0, label]


# --------------------------------------------------------------------- #
def optimizer_rule(name: str, shape: Sequence[int], arch: Dict,
                   opt: Dict) -> Tuple[float, float]:
    """(rate, weight decay) of one parameter."""
    depth = arch["depth"]
    if name.startswith(("cls_token", "patch_embed")):
        lid = 0
    elif name.startswith("encoder.layers."):
        lid = int(name.split(".")[2]) + 1
    else:
        lid = depth + 1
    lr = opt["lr"] * opt["layer_decay"] ** (depth + 1 - lid)
    wd = 0.0 if len(shape) == 1 or name == "cls_token" else opt["weight_decay"]
    return lr, wd


def reference_steps(w: Dict[str, torch.Tensor], slides: Sequence[Tuple],
                    arch: Dict, opt: Dict, device, fault: Optional[str] = None,
                    fp8: bool = False, mask_pads: bool = False) -> Dict:
    """One AdamW step a slide over `slides` [(features [N, in_dim],
    coordinates [N, 2], label)] from weights `w`: the losses, the first
    gradient (`grad1`, and `adam1`, Adam's first moment after step 1 over
    1 - beta1: the same), and the parameters after the last step; leaves
    keyed "params/<name>"."""
    device = torch.device(device)
    b1, b2 = BETAS
    p = {k: v.detach().to(device).clone().requires_grad_(True) for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s2 = {k: torch.zeros_like(v) for k, v in p.items()}
    rules = {k: optimizer_rule(k, v.shape, arch, opt) for k, v in p.items()}
    losses, grad1 = [], None
    for step, (x, c, label) in enumerate(slides, 1):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
        c = torch.as_tensor(np.asarray(c), device=device)
        loss = cross_entropy(logits(p, x, c, arch, fault, fp8, mask_pads), int(label))
        # a skipped layer's parameters get a zero gradient
        grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(
            p.items(), torch.autograd.grad(loss, list(p.values()), allow_unused=True))}
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {f"params/{k}": g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                lr, wd = rules[k]
                p[k].mul_(1 - lr * wd)
                m[k].mul_(b1).add_((1 - b1) * g)
                s2[k].mul_(b2).add_((1 - b2) * g * g)
                denom = (s2[k].sqrt() / math.sqrt(1 - b2 ** step)) + EPS
                p[k].sub_(lr / (1 - b1 ** step) * m[k] / denom)
    return {"losses": losses, "grad1": grad1, "adam1": grad1,
            "params": {f"params/{k}": v.detach() for k, v in p.items()}}


# --------------------------------------------------------------------- #
def attention_flops(t: int, arch: Dict = ARCH) -> int:
    """One layer's forward attention at T tokens: every pair's segments,
    padding included: per segment and head, q k^T and the product with v
    over L = ceil(s / r) rows, 2 x 2 x L^2 x head_dim."""
    hd = arch["dim"] // arch["heads"]
    total = 0
    for w, r in zip(arch["segment_lengths"], arch["dilated_ratios"]):
        _, n_seg, length = _geometry(t, w, r)
        total += n_seg * arch["heads"] * 4 * length * length * hd
    return total


def dense_flops(t: int, arch: Dict = ARCH) -> int:
    """The forward's linear maps at T tokens (T - 1 tiles): the input
    projection, each layer's q, k, v, out, fc1 and fc2, and the head."""
    d, hid = arch["dim"], arch["mlp_hidden"]
    per_layer = 2 * t * (4 * d * d + 2 * d * hid)
    return (2 * (t - 1) * arch["in_dim"] * d + arch["depth"] * per_layer
            + 2 * d * arch["n_classes"])


def forward_flops(t: int, arch: Dict = ARCH) -> int:
    """The forward pass at T tokens by hand: dense and attention."""
    return dense_flops(t, arch) + arch["depth"] * attention_flops(t, arch)
