"""The port's collective calls over `torch.distributed`, each counted.

Every all-reduce and broadcast the port issues goes through this module,
so a run can say which collectives a path used (`counts()`): the
data-parallel step issues only all-reduces, the sharded featurizer none
(parallel/dryrun.py, the tests). The counts are plain integers that
`reset_counts()` sets to 0.

`all_reduce_sum` is differentiable. Its backward is the SUM of the
incoming gradient over the group, not the identity. That is the rule for
edge sharding (parallel/big_graph.py): every rank holds the same
replicated parameters and computes the same loss from the summed
partials, so the gradient of rank r's partial is the sum of every rank's
upstream gradient, and rank r's parameter gradient then holds the edge
path's share of the true gradient times the world size, plus the
replicated path's share once. Summed over the ranks and divided by the
world size (`average_gradients`), that is the single-device gradient.
Example, two ranks, partial w * (rank + 1) summed, loss 5 * sum: the true
gradient is 15; the ranks read 10 and 20, whose mean is 15.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

_COUNTS: Dict[str, int] = {"all_reduce": 0, "broadcast": 0}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def counts() -> Dict[str, int]:
    """Collective calls issued since the last reset, by kind."""
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def all_reduce_(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor (no autograd)."""
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_reduced(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A reduced copy of `x`, outside autograd: counts, degrees, and the
    softmax's stabilising maximum."""
    with torch.no_grad():
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format),
                           op, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           "sum", ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over the group, differentiable: forward and backward both sum
    over the group (see the module docstring for why)."""
    return _AllReduceSum.apply(x, group)


def broadcast_(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast from global rank `src`."""
    _COUNTS["broadcast"] += 1
    dist.broadcast(x, src=src, group=group)
    return x


def average_gradients(params: Iterable[torch.Tensor], group=None,
                      world: Optional[int] = None) -> None:
    """Every parameter's `.grad` summed over the group (one all-reduce of
    the gradients flattened into one buffer) and divided by `world`
    (None: no division). A parameter without a gradient takes part with
    zeros, so every rank sends the same buffer."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not params:
        return
    flat = all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]),
                       "sum", group)
    if world:
        flat.div_(world)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
