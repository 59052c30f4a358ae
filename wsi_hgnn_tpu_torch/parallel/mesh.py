"""Devices and process groups: the port's communication layer
(counterpart of wsi_hgnn_tpu/parallel/mesh.py).

The JAX package names its devices with one `jax.sharding.Mesh` and lets
XLA place and partition arrays. The port runs two forms:

  * one process driving several devices (the featurizer's data
    parallelism, the counterpart of the reference's `torch.nn.DataParallel`
    around its constructor CNNs): `make_sharded_batch_apply` keeps one
    replica of the weights per device, splits each batch into equal
    contiguous parts, launches every part on its device and joins the
    results in order on the host. Nothing synchronises before the join,
    so the devices' work overlaps. It issues no collective. A device list
    may repeat one device (one replica serves every repeat);
  * one process per device under `torch.distributed` (data-parallel
    training, parallel/dp.py; edge sharding, parallel/big_graph.py):
    `make_mesh` then carries this rank's device, the rank, the world size
    and the process group, and every collective goes through
    `collectives.py`.

What stands in for the JAX package's placement helpers: `replicated`
(params on every device) is the per-device replica of the first form and
the rank-0 broadcast of `dp.place_state` in the second; `data_sharded`
(the batch's leading axis over the mesh) is `make_sharded_batch_apply`'s
split in the first form and `shard_stacked`, which keeps each rank's row
of a stacked batch, in the second.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import stack_graphs
from ..graph.typed_graph import TypedGraph
from ..profiling import span
from ..utils import resolve_device, to_torch

DATA_AXIS = "data"

__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "make_sharded_batch_apply",
           "make_dp_featurizer", "stack_graphs", "shard_stacked"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices a batch is split over in this process, and, under
    `torch.distributed`, this rank, the world size and the group (None
    and 1 in a single process)."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        """This process's (first) device."""
        return self.devices[0]


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """Under an initialised process group: this rank's mesh (its device is
    `device`, by default cuda:LOCAL_RANK; `n_devices`, when given, must
    be the world size). Otherwise the devices of one process: the first
    `n_devices` cards (all by default), or `n_devices` times the CPU when
    `device` is 'cpu' (tests)."""
    if distributed():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"requested {n_devices} devices in a world of "
                             f"{world} processes")
        if device is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        return Mesh((resolve_device(device),), dist.get_rank(), world,
                    dist.group.WORLD)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1))
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"requested {n} devices, only {have} available")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _device_list(devices: Union[Mesh, Sequence]) -> Tuple[torch.device, ...]:
    if isinstance(devices, Mesh):
        return devices.devices
    return tuple(torch.device(d) for d in devices)


def _map(tree, fn):
    """fn over the tensor leaves of a tensor, tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def _join(parts):
    """Per-device outputs (a tensor or a tuple of tensors each) joined
    along the batch axis on the host, in device order."""
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_join([p[i] for p in parts])
                           for i in range(len(first)))
    return torch.cat([p.cpu() for p in parts])


def _to_host_async(x):
    """A device tensor (or a tuple of them) queued for a copy into pinned
    host memory behind the work that makes it; host tensors as they are."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host_async(v) for v in x)
    if x.device.type != "cuda":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x, non_blocking=True)


def make_sharded_batch_apply(fn: Callable, devices) -> Callable:
    """`fn(device)` builds the program of one device (its weights placed
    there): a callable from a batch part on that device to a tensor or a
    tuple of tensors with the batch on the leading axis. Returns
    `apply(batch)`: the batch (host or any device) split into
    len(devices) equal contiguous parts (the caller pads: the batch must
    divide), each run on its device, the results joined in order on the
    host. One replica per distinct device; no collective.

    `apply` is `apply.finish(apply.launch(batch))`: `launch` uploads the
    parts, queues every device's work and the copies of its results to
    pinned host memory, and returns without waiting; `finish` waits for
    those copies and joins them. A caller may launch the next batch
    before it finishes this one, so the host's upload work overlaps the
    devices'. While a profiler runs, the copies to the devices are an
    `encode/upload` span and the wait and join an `encode/download` span."""
    devs = _device_list(devices)
    replicas = {}
    for d in devs:
        if d not in replicas:
            replicas[d] = fn(d)

    def launch(batch: torch.Tensor):
        b, n = batch.shape[0], len(devs)
        if b % n:
            raise ValueError(f"batch of {b} does not divide over {n} "
                             "devices; pad it first")
        per = b // n
        with span("encode/upload"):
            if batch.device.type == "cpu" and any(d.type == "cuda"
                                                  for d in devs):
                batch = batch.pin_memory()   # asynchronous copies to the cards
            parts = [batch[i * per:(i + 1) * per].to(d, non_blocking=True)
                     for i, d in enumerate(devs)]
        # launch every part before reading any result back
        outs = [_to_host_async(replicas[d](part))
                for part, d in zip(parts, devs)]
        done = []
        for d in dict.fromkeys(devs):
            if d.type == "cuda":
                done.append(torch.cuda.Event())
                done[-1].record(torch.cuda.current_stream(d))
        return outs, done

    def finish(launched):
        outs, done = launched
        with span("encode/download"):
            for event in done:
                event.synchronize()
            return _join(outs)

    def apply(batch: torch.Tensor):
        return finish(launch(batch))

    apply.launch, apply.finish = launch, finish
    apply.devices = devs
    return apply


def make_dp_featurizer(apply_fn: Callable, devices) -> Callable:
    """`apply_fn(variables, patches) -> features` as a data-parallel
    `fn(variables, patches)`: the variables (a tensor tree) copied to each
    device, the patch batch split over the devices (it must divide), the
    features joined on the host in order."""
    devs = _device_list(devices)

    def fn(variables, patches):
        placed = {d: _map(variables, lambda t, d=d: t.to(d)) for d in set(devs)}
        run = make_sharded_batch_apply(
            lambda d: (lambda p: apply_fn(placed[d], p)), devs)
        return run(patches)

    return fn


def shard_stacked(stacked, mesh: Mesh):
    """This rank's row of a stacked batch (a TypedGraph or an array with
    the ranks on the leading axis), on this rank's device: the
    counterpart of placing the leading axis sharded over the mesh. A
    TypedGraph comes back as a device graph; an array as a tensor
    (integers as int64, the dtype the losses index with)."""
    if isinstance(stacked, TypedGraph):
        row = stacked.replace(**{
            f: None if getattr(stacked, f) is None
            else np.asarray(getattr(stacked, f))[mesh.rank]
            for f in ("feat", "node_type", "node_graph", "node_mask", "src",
                      "dst", "esign", "sim", "edge_mask", "edge_weight")})
        return row.to_torch(mesh.device)
    row = np.asarray(stacked)[mesh.rank]
    return to_torch(row, mesh.device, torch.int64
                    if np.issubdtype(row.dtype, np.integer) else None)
