"""SimCLR contrastive featurizer pretraining and the tile-grid helpers of
GTN (counterpart of wsi_hgnn_tpu/models/mil/simclr.py).

  * `nt_xent_loss`: normalised-temperature cross entropy over the 2B
    views, self-similarity masked.
  * `augment_pair`: two views per image: a random crop of 0.8 of each
    side resized back up bilinearly (half-pixel centres, no antialias),
    a horizontal flip with probability 1/2, a brightness factor
    U[0.8, 1.2), clipped to [0, 1]. The draws come from a torch.Generator
    (`draw_views`) or are passed in.
  * `simclr_train_step`: one contrastive step for any projection
    function (both views through it in one batch of 2B).
  * `spatial_adjacency`, `coords_from_patch_names`: 8-neighbour edges
    from `{col}_{row}` tile coordinates.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CROP_FRAC = 0.8


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor,
                 temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent of the [B, D] projections of two views."""
    b = z1.shape[0]
    z = torch.cat([z1, z2], 0)
    z = z / torch.linalg.norm(z, dim=1, keepdim=True).clamp_min(1e-12)
    sim = z @ z.T / temperature
    sim = sim.masked_fill(torch.eye(2 * b, dtype=torch.bool,
                                    device=z.device), -1e9)
    pos = torch.cat([torch.arange(b) + b, torch.arange(b)]).to(z.device)
    logprob = F.log_softmax(sim, 1)
    return -logprob.gather(1, pos[:, None]).mean()


def draw_views(b: int, h: int, w: int, generator: Optional[torch.Generator],
               crop_frac: float = CROP_FRAC, device=None) -> Tuple[Dict, Dict]:
    """The random draws of two views of b images: per view `top`, `left`
    (crop offsets), `flip` (bool) and `bright` (factor), each [b]."""
    ch, cw = int(h * crop_frac), int(w * crop_frac)
    device = generator.device if generator is not None else device

    def one():
        kw = dict(generator=generator, device=device)
        return dict(top=torch.randint(0, h - ch + 1, (b,), **kw),
                    left=torch.randint(0, w - cw + 1, (b,), **kw),
                    flip=torch.rand(b, **kw) < 0.5,
                    bright=0.8 + 0.4 * torch.rand(b, **kw))
    return one(), one()


def augment_view(images: torch.Tensor, view: Dict,
                 crop_frac: float = CROP_FRAC) -> torch.Tensor:
    """One view of images [B, H, W, C] in [0, 1] under the draws `view`."""
    b, h, w, c = images.shape
    ch, cw = int(h * crop_frac), int(w * crop_frac)
    dev = images.device
    rows = view["top"].to(dev)[:, None] + torch.arange(ch, device=dev)
    cols = view["left"].to(dev)[:, None] + torch.arange(cw, device=dev)
    crops = images[torch.arange(b, device=dev)[:, None, None],
                   rows[:, :, None], cols[:, None, :]]          # [B, ch, cw, C]
    out = F.interpolate(crops.permute(0, 3, 1, 2), size=(h, w),
                        mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1)
    out = torch.where(view["flip"].to(dev)[:, None, None, None],
                      out.flip(2), out)
    bright = view["bright"].to(dev, images.dtype)[:, None, None, None]
    return (out * bright).clamp(0.0, 1.0)


def augment_pair(images: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 views: Optional[Tuple[Dict, Dict]] = None,
                 crop_frac: float = CROP_FRAC
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two stochastic views of images [B, H, W, C]; the draws from
    `generator` (draw_views) unless `views` gives them."""
    if views is None:
        b, h, w, _ = images.shape
        views = draw_views(b, h, w, generator, crop_frac, images.device)
    return (augment_view(images, views[0], crop_frac),
            augment_view(images, views[1], crop_frac))


def simclr_loss(project: Callable[[torch.Tensor], torch.Tensor],
                images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                views: Optional[Tuple[Dict, Dict]] = None,
                temperature: float = 0.5) -> torch.Tensor:
    """NT-Xent of the two views' projections; `project` maps [2B, H, W, C]
    images to [2B, P]."""
    v1, v2 = augment_pair(images, generator, views)
    z = project(torch.cat([v1, v2], 0))
    b = images.shape[0]
    return nt_xent_loss(z[:b], z[b:], temperature)


def simclr_train_step(project: Callable[[torch.Tensor], torch.Tensor],
                      opt: torch.optim.Optimizer, images: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      views: Optional[Tuple[Dict, Dict]] = None
                      ) -> torch.Tensor:
    """One SimCLR step: the loss of `simclr_loss`, its gradient, one step
    of `opt` (whose parameters are the ones trained)."""
    opt.zero_grad()
    loss = simclr_loss(project, images, generator, views)
    loss.backward()
    opt.step()
    return loss.detach()


def spatial_adjacency(coords: Sequence[Tuple[int, int]]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) 8-neighbour spatial edges from `{col}_{row}` tile
    coordinates: tiles adjacent on the grid (diagonals included) are
    connected, both directions."""
    index = {tuple(c): i for i, c in enumerate(coords)}
    src, dst = [], []
    for i, (x, y) in enumerate(coords):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                j = index.get((x + dx, y + dy))
                if j is not None:
                    src.append(i)
                    dst.append(j)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def coords_from_patch_names(names: Sequence[str]) -> List[Tuple[int, int]]:
    """`{col}_{row}.jpeg` tile filenames -> (col, row) ints."""
    out = []
    for n in names:
        x, y = n.rsplit(".", 1)[0].split("_")[:2]
        out.append((int(x), int(y)))
    return out
