"""Data-parallel training steps over a process group (counterpart of
wsi_hgnn_tpu/parallel/dp.py).

One process per device; each rank trains on its own bucket of slide
graphs (a TypedGraph batch, or the [B, N, k] lattice form) against the
same replicated parameters. The step is explicit, not
DistributedDataParallel, because it keeps the JAX package's semantics,
which differ from DDP's defaults:

  * the loss is the weighted mean over the GLOBAL batch,
    sum(nll * w) / max(sum(w), 1): each rank scales its local numerator
    by the all-reduced denominator and the gradients are SUMMED, so a
    rank whose bucket carries weight-0 padding graphs counts for what it
    holds (averaging per-rank means would not);
  * BatchNorm running statistics are averaged over the ranks after the
    step (DDP broadcasts rank 0's buffers);
  * dropout and augmentation are drawn per rank, from distinct generator
    streams (`rank_generator`), as JAX splits its keys per device.

Every collective is an all-reduce (collectives.py counts them):
the weight sum, the gradients in one flat buffer, the running statistics
of BatchNorm models, and the reported loss. `place_state` broadcasts rank
0's parameters, buffers and optimizer state before the first step.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..collectives import (all_reduce_, all_reduced, average_gradients,
                           broadcast_)
from ..graph import transforms
from ..graph.typed_graph import to_homogeneous
from ..models.lattice import apply_train_masks, draw_train_masks
from ..models.layers import DropSource, MaskedBatchNorm
from .mesh import Mesh

AUG_P = 0.5   # the reference's augmentation probability


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """This rank's generator on its device: one stream per rank."""
    return torch.Generator(device=mesh.device).manual_seed(
        seed * mesh.world + mesh.rank)


def _running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, MaskedBatchNorm)
            for b in (m.mean, m.var)]


def _make_dp_step(model, optimizer, loss_fcn, mesh: Mesh,
                  forward: Callable) -> Callable:
    """The shared step; `forward(g, generator) -> logits` (augmentation
    and dropout included) is what differs between the TypedGraph and the
    lattice forms."""
    stats = _running_stats(model)

    def step(g, labels: torch.Tensor, weights: torch.Tensor,
             generator: torch.Generator):
        model.train()
        optimizer.zero_grad(set_to_none=False)
        logits = forward(g, generator)
        w_local = weights.sum()
        w_global = all_reduced(w_local, "sum", mesh.group)
        # the local numerator sum(nll * w) over the global denominator
        loss = (loss_fcn(logits, labels, weights) * w_local.clamp_min(1.0)
                / w_global.clamp_min(1.0))
        loss.backward()
        average_gradients(model.parameters(), mesh.group)
        optimizer.step()
        if stats:
            flat = all_reduce_(torch.cat([s.reshape(-1) for s in stats]),
                               "sum", mesh.group).div_(mesh.world)
            off = 0
            for s in stats:
                s.copy_(flat[off:off + s.numel()].view_as(s))
                off += s.numel()
        total = all_reduced(loss, "sum", mesh.group)
        return total, torch.softmax(logits.detach(), -1)

    return step


def make_dp_train_step(model, optimizer, loss_fcn, is_hetero: bool,
                       mesh: Mesh, augment: bool = True) -> Callable:
    """`step(g, labels, weights, generator) -> (loss, probs)` in place on
    `model` and `optimizer`: `g` is this rank's TypedGraph batch on its
    device, `generator` this rank's (rank_generator); the loss returned
    is the global batch's, the probabilities this rank's."""

    def forward(g, generator):
        if not is_hetero:
            g = to_homogeneous(g)
        if augment:
            g = transforms.train_transform(g, generator, AUG_P)
        return model(g, DropSource(generator))

    return _make_dp_step(model, optimizer, loss_fcn, mesh, forward)


def make_dp_lattice_train_step(model, optimizer, loss_fcn, mesh: Mesh,
                               augment: bool = True) -> Callable:
    """make_dp_train_step on the lattice form: `model` is a lattice twin
    (config.parse_lattice_twin) and `g` this rank's LatticeGraph."""

    def forward(g, generator):
        if augment:
            g = apply_train_masks(g, draw_train_masks(g, generator, AUG_P))
        return model(g, generator=generator)

    return _make_dp_step(model, optimizer, loss_fcn, mesh, forward)


def place_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                mesh: Mesh) -> None:
    """Replicate the training state: rank 0's parameters, buffers and
    optimizer state broadcast to every rank, in place."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            broadcast_(t.data, 0, mesh.group)
        for p in model.parameters():
            for v in optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor) and v.device == p.device:
                    broadcast_(v, 0, mesh.group)
