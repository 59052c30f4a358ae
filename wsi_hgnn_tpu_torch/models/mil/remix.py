"""ReMix: prototype-based bag reduction and latent augmentation
(counterpart of wsi_hgnn_tpu/models/mil/remix.py).

  * `kmeans`: Lloyd's k-means on the bag's device (assignment = argmin
    of one GEMM's distances, update = segment mean, empty clusters keep
    their centroid), the final assignment against the RETURNED centroids;
  * `reduce_bag`: K prototypes plus per-cluster "semantic shift" vectors
    drawn from N(0, cluster covariance);
  * `mix_aug` / `mix_the_bag_aug`: latent augmentation between a source
    bag and a same-class target bag, modes replace / append / interpolate
    / cov / joint, on the host.
The k-means++ initial centres come from a torch.Generator seeded with
`seed` (the JAX package draws them from jax.random.PRNGKey(seed), which
torch cannot reproduce), or are given (`init_centroids`). The covariance
draws and the augmentation draws use numpy RandomStates as in JAX, so
given equal assignments the outputs are equal.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _sq_dists(feats: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    return ((feats ** 2).sum(1, keepdim=True) - 2 * feats @ cent.T
            + (cent ** 2).sum(1)[None, :])


def kmeans_pp_init(feats: torch.Tensor, k: int, seed: int = 66
                   ) -> torch.Tensor:
    """k-means++: the first centre uniform, each next one drawn in
    proportion to the squared distance from the chosen set."""
    n = feats.shape[0]
    gen = torch.Generator(device=feats.device).manual_seed(seed)
    first = torch.randint(n, (1,), generator=gen, device=feats.device)
    cents = [feats[first[0]]]
    d2min = ((feats - cents[0]) ** 2).sum(1)
    for _ in range(1, k):
        w = d2min.clamp_min(0.0)
        if not bool(w.sum() > 0):
            w = torch.ones_like(w)
        nxt = torch.multinomial(w, 1, generator=gen)[0]
        cents.append(feats[nxt])
        d2min = torch.minimum(d2min, ((feats - feats[nxt]) ** 2).sum(1))
    return torch.stack(cents)


def kmeans(feats: torch.Tensor, k: int, iters: int = 20, seed: int = 66,
           init_centroids: Optional[torch.Tensor] = None):
    """(centroids [k, D], assignments [N]) on feats' device."""
    n = feats.shape[0]
    cent = (kmeans_pp_init(feats, k, seed) if init_centroids is None
            else torch.as_tensor(init_centroids, dtype=feats.dtype,
                                 device=feats.device))
    ones = feats.new_ones(n)
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(feats, cent), 1)
        sums = feats.new_zeros(k, feats.shape[1]).index_add_(0, assign, feats)
        cnts = feats.new_zeros(k).index_add_(0, assign, ones)
        new = sums / cnts.clamp_min(1.0)[:, None]
        cent = torch.where((cnts > 0)[:, None], new, cent)
    return cent, torch.argmin(_sq_dists(feats, cent), 1)


def reduce_bag(feats: np.ndarray, num_prototypes: int,
               num_shift_vectors: int = 200, seed: int = 66,
               device: Optional[torch.device] = None,
               init_centroids: Optional[np.ndarray] = None):
    """(prototypes [K, D], shift_vectors [K, S, D]) of one bag; k-means
    on `device` (the CPU by default), the covariance draws on the host."""
    dev = torch.device("cpu") if device is None else device
    cent, assign = kmeans(
        torch.as_tensor(np.asarray(feats, np.float32), device=dev),
        num_prototypes, seed=seed,
        init_centroids=None if init_centroids is None else
        torch.as_tensor(np.asarray(init_centroids, np.float32), device=dev))
    cent, assign = cent.cpu().numpy(), assign.cpu().numpy()
    rng = np.random.RandomState(seed)
    shifts = []
    d = feats.shape[1]
    for i in range(num_prototypes):
        members = feats[assign == i]
        if len(members) >= 2:
            cov = np.cov(members.T)
        else:
            cov = np.eye(d, dtype=np.float64) * 1e-6
        shifts.append(
            rng.multivariate_normal(np.zeros(d), cov, size=num_shift_vectors))
    return cent, np.asarray(shifts, np.float32)


def mix_aug(src_feats: np.ndarray, tgt_feats: np.ndarray,
            mode: str = "replace", rate: float = 0.3, strength: float = 0.5,
            shift: Optional[np.ndarray] = None,
            rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Latent inter-bag augmentation against the closest target
    prototype of each source instance, applied with probability `rate`."""
    assert mode in ("replace", "append", "interpolate", "cov", "joint")
    rng = rng or np.random.RandomState()
    d = src_feats.shape[-1]
    src = src_feats.reshape(-1, d)
    tgt = tgt_feats.reshape(-1, d)
    auged = [f for f in src]
    d2 = ((src ** 2).sum(1, keepdims=True) - 2 * src @ tgt.T
          + (tgt ** 2).sum(1)[None])
    closest = np.argmin(d2, axis=1)

    def apply(ix, m):
        if m == "replace":
            auged[ix] = tgt[closest[ix]]
        elif m == "append":
            auged.append(tgt[closest[ix]])
        elif m == "interpolate":
            auged.append((1 - strength) * auged[ix] + strength * tgt[closest[ix]])
        elif m == "cov":
            sv = shift[closest[ix]][rng.choice(shift.shape[1], 1)]
            auged.append((auged[ix][None, :] + strength * sv).flatten())

    for ix in range(len(src)):
        if mode != "joint":
            if rng.rand() <= rate:
                apply(ix, mode)
        else:
            for m in ("replace", "append", "interpolate", "cov"):
                if rng.rand() <= rate:
                    apply(ix, m)
    return np.asarray(auged, np.float32)


def mix_the_bag_aug(bag_feats: np.ndarray, idx: int, train_feats,
                    train_labels, mode: Optional[str], rate: float,
                    semantic_shifts=None,
                    rng: Optional[np.random.RandomState] = None
                    ) -> np.ndarray:
    """Pick a same-class bag and augment against it."""
    if mode is None:
        return bag_feats
    rng = rng or np.random.RandomState()
    labels = np.asarray(train_labels)
    positive = np.argwhere(labels == labels[idx]).reshape(-1)
    selected = rng.choice(positive)
    strength = rng.uniform(0, 1)
    return mix_aug(
        bag_feats, np.asarray(train_feats[selected]),
        shift=semantic_shifts[selected] if mode in ("joint", "cov") else None,
        rate=rate, strength=strength, mode=mode, rng=rng)
