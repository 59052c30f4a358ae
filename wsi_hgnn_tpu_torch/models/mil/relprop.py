"""LRP relevance propagation for the GTNMIL ViT: GraphCAM (counterpart of
wsi_hgnn_tpu/models/mil/relprop.py).

The reference's transformer attribution (Chefer et al.):

* the LRP rules of the reference's layers: `safe_divide`, the alpha-beta
  Linear rule at alpha = 1 (`linear_relprop`), the generic rule for
  einsum products (`simple_relprop`, its vector-Jacobian product taken by
  `torch.autograd.grad`), the renormalised Add rule (`add_relprop`) and
  Clone (`clone_relprop`); Softmax, LayerNorm, GELU and Dropout pass
  relevance through unchanged;
* the module order of the reference's ViT relprop: Attention (with the
  halving after each product's split and the attention cam taken after
  it), Block, the whole transformer, and `compute_rollout_attention`;
* the GraphCAM driver: attention gradients of p_c * softmax(logits)[c]
  (p_c the detached class probability), taken with respect to zero
  additive taps on each block's post-softmax attention, and the relprop
  seeded with the same one-hot vector carrying p_c.

`vit_forward` and `vit_relprop` read the weights of the port's
`GraphTransformer` (blocks `blocks_{i}` with norm1/qkv/proj/norm2/fc1/fc2,
then `norm` and `head`); `linear_relprop` takes its kernel in the flax
[in, out] layout, the transpose of an nn.Linear weight.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def safe_divide(a, b):
    """a / b with the denominator pushed 1e-9 away from 0 on its own side;
    where b is exactly 0 the result is 0."""
    den = b.clamp(min=1e-9) + b.clamp(max=1e-9)
    den = den + (den == 0).to(den.dtype) * 1e-9
    return a / den * (b != 0).to(b.dtype)


def linear_relprop(R, x, kernel):
    """Alpha-beta LRP of a Linear layer at alpha = 1: only the activator
    term x+.w+ + x-.w- survives; the bias is excluded. kernel [in, out]."""
    pw, nw = kernel.clamp(min=0.0), kernel.clamp(max=0.0)
    px, nx = x.clamp(min=0.0), x.clamp(max=0.0)
    S = safe_divide(R, px @ pw + nx @ nw)
    return px * (S @ pw.T) + nx * (S @ nw.T)


def simple_relprop(f, R, *xs):
    """The generic rule: S = R / f(xs), C = the vector-Jacobian product of
    f at xs with S, relevance x * C per input."""
    leaves = [x.detach().requires_grad_() for x in xs]
    with torch.enable_grad():
        Z = f(*leaves)
        Cs = torch.autograd.grad(Z, leaves, safe_divide(R, Z.detach()))
    return tuple(x * c for x, c in zip(xs, Cs))


def add_relprop(R, x0, x1):
    """The renormalised Add rule: split by S = R / (x0 + x1), then rescale
    each branch so the branch totals share R.sum() by their magnitudes."""
    S = safe_divide(R, x0 + x1)
    a, b = x0 * S, x1 * S
    a_sum, b_sum = a.sum(), b.sum()
    tot = a_sum.abs() + b_sum.abs()
    a_fact = safe_divide(a_sum.abs(), tot) * R.sum()
    b_fact = safe_divide(b_sum.abs(), tot) * R.sum()
    return a * safe_divide(a_fact, a.sum()), b * safe_divide(b_fact, b.sum())


def clone_relprop(Rs, x):
    """Clone: R = x * sum_i(R_i / x)."""
    return x * sum(safe_divide(R, x) for R in Rs)


def _layer_norm(x, norm, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * norm.weight + norm.bias


def _kernel(linear):
    """An nn.Linear's weight in the flax [in, out] layout."""
    return linear.weight.T


def _linear(x, linear):
    out = x @ _kernel(linear)
    return out if linear.bias is None else out + linear.bias


def vit_forward(model, x, heads: int = 8,
                attn_taps: Optional[List[torch.Tensor]] = None,
                record: Optional[Dict] = None):
    """The ViT tail of `model` (a GraphTransformer: blocks -> norm -> cls
    head) as a function of the tokens x [B, n, dim] -> logits [B, C].

    `attn_taps`: per-block tensors added to the post-softmax attention;
    the gradient with respect to them is the reference's saved attention
    gradient. `record`: a dict filled with every intermediate the LRP
    backward pass reads."""
    b, n, dim = x.shape
    hd = dim // heads
    scale = hd ** -0.5
    blocks = []
    for i in range(model.depth):
        p = getattr(model, f"blocks_{i}")
        x_in = x
        h = _layer_norm(x, p.norm1, 1e-6)
        # einops 'b n (qkv h d) -> qkv b h n d'
        qkv = (h @ _kernel(p.qkv)).reshape(b, n, 3, heads, hd
                                          ).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * scale,
                             -1)
        if attn_taps is not None:
            attn = attn + attn_taps[i]
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        proj_in = out.permute(0, 2, 1, 3).reshape(b, n, dim)
        attn_out = _linear(proj_in, p.proj)
        x_mid = x_in + attn_out
        h2 = _layer_norm(x_mid, p.norm2, 1e-6)
        g = F.gelu(_linear(h2, p.fc1))
        f2 = _linear(g, p.fc2)
        x = x_mid + f2
        if record is not None:
            blocks.append(dict(x_in=x_in, h=h, q=q, k=k, v=v, attn=attn,
                               proj_in=proj_in, attn_out=attn_out,
                               x_mid=x_mid, h2=h2, g=g, f2=f2))
    nrm = _layer_norm(x, model.norm, 1e-5)   # torch LayerNorm's default eps
    cls = nrm[:, 0]
    logits = _linear(cls, model.head)
    if record is not None:
        record.update(blocks=blocks, nrm=nrm, cls=cls)
    return logits


def compute_rollout_attention(all_layer_matrices, start_layer: int = 0):
    """Add the identity to each layer's matrix and chain-multiply upward."""
    eye = torch.eye(all_layer_matrices[0].shape[-1],
                    dtype=all_layer_matrices[0].dtype,
                    device=all_layer_matrices[0].device)
    mats = [m + eye for m in all_layer_matrices]
    joint = mats[start_layer]
    for i in range(start_layer + 1, len(mats)):
        joint = mats[i] @ joint
    return joint


@torch.no_grad()
def vit_relprop(model, x, class_idx: int, heads: int = 8,
                method: str = "transformer_attribution",
                start_layer: int = 0):
    """GraphCAM over the ViT input tokens x [1, n, dim]: the cls-token
    relevance row over the non-cls tokens, [n - 1]. Methods:
    'transformer_attribution' (= 'grad'), 'rollout', 'last_layer_attn'."""
    x = x.detach()
    rec: Dict = {}
    logits = vit_forward(model, x, heads=heads, record=rec)
    p_c = torch.softmax(logits, -1)[0, class_idx]

    # attention gradients of p_c * softmax(logits)[c], p_c detached
    taps = [torch.zeros_like(blk["attn"]).requires_grad_()
            for blk in rec["blocks"]]
    with torch.enable_grad():
        lg = vit_forward(model, x, heads=heads, attn_taps=taps)
        attn_grads = torch.autograd.grad(
            p_c * torch.softmax(lg, -1)[0, class_idx], taps)

    # the LRP backward pass, seeded with the same one-hot
    R = torch.zeros_like(logits)
    R[0, class_idx] = p_c
    R = linear_relprop(R, rec["cls"], _kernel(model.head))
    # IndexSelect scatters the cls relevance back to token 0
    nrm0 = rec["nrm"][:, 0]
    row0 = nrm0 * safe_divide(R, nrm0)
    R = torch.zeros_like(rec["nrm"])
    R[:, 0] = row0

    depth = len(rec["blocks"])
    attn_cams = [None] * depth
    for i in reversed(range(depth)):
        blk = rec["blocks"][i]
        p = getattr(model, f"blocks_{i}")
        # Block: add2 -> mlp -> clone2
        R1, R2 = add_relprop(R, blk["x_mid"], blk["f2"])
        R2 = linear_relprop(R2, blk["g"], _kernel(p.fc2))
        R2 = linear_relprop(R2, blk["h2"], _kernel(p.fc1))
        R = clone_relprop([R1, R2], blk["x_mid"])
        # add1 -> attention -> clone1
        R1, R2 = add_relprop(R, blk["x_in"], blk["attn_out"])
        R2 = linear_relprop(R2, blk["proj_in"], _kernel(p.proj))
        b, n, dim = R2.shape
        hd = dim // heads
        cam = R2.reshape(b, n, heads, hd).permute(0, 2, 1, 3)
        cam_attn, cam_v = simple_relprop(
            lambda a, v: torch.einsum("bhij,bhjd->bhid", a, v),
            cam, blk["attn"], blk["v"])
        cam_attn, cam_v = cam_attn / 2, cam_v / 2
        attn_cams[i] = cam_attn        # taken after the halving
        # softmax relprop is the identity; the product is q k^T unscaled
        cam_q, cam_k = simple_relprop(
            lambda q, k: torch.einsum("bhid,bhjd->bhij", q, k),
            cam_attn, blk["q"], blk["k"])
        cam_q, cam_k = cam_q / 2, cam_k / 2
        # einops '[q,k,v] b h n d -> b n (qkv h d)'
        cam_qkv = torch.stack([cam_q, cam_k, cam_v], 0).permute(
            1, 3, 0, 2, 4).reshape(b, n, 3 * dim)
        R2 = linear_relprop(cam_qkv, blk["h"], _kernel(p.qkv))
        R = clone_relprop([R1, R2], blk["x_in"])

    if method == "rollout":
        mats = [c.clamp(min=0.0).mean(1) for c in attn_cams]
        return compute_rollout_attention(mats, start_layer)[0, 0, 1:]
    if method in ("transformer_attribution", "grad"):
        cams = [(attn_grads[i][0] * attn_cams[i][0]).clamp(min=0.0
                                                          ).mean(0)[None]
                for i in range(depth)]
        return compute_rollout_attention(cams, start_layer)[0, 0, 1:]
    if method == "last_layer_attn":
        return rec["blocks"][-1]["attn"][0].clamp(min=0.0).mean(0)[0, 1:]
    raise NotImplementedError(f"relprop method {method!r}")
