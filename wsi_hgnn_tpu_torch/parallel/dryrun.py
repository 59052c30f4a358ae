"""The multi-device dry run (counterpart of the root
`__graft_entry__.py::dryrun_multichip`, which stays the JAX package's):

    python -m wsi_hgnn_tpu_torch.parallel.dryrun 4               # 4 cards, NCCL
    python -m wsi_hgnn_tpu_torch.parallel.dryrun 4 --device cpu  # 4 CPU processes, gloo

spawns a world of N processes (one card each; with fewer than N cards
it raises, and runs on the CPU only when asked) and runs one step of each parallel path on
tiny shapes: the data-parallel HEAT4 step, the edge-sharded HEAT4 step,
the data-parallel lattice step with a few masked edge slots, the
data-parallel featurizer, and sharded construction (KimiaNet and
HoVer-Net typing over one 96 x 96 patch stream, the graph, HEAT4
logits). In place of XLA's collective census it counts the port's own
collective calls (collectives.py): the data-parallel step issues only
all-reduces, the featurizer and construction none. Rank 0 prints one
summary line.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

HEAT4 = {"name": "HEAT4", "n_node_types": 6, "num_layers": 2, "in_dim": 32,
         "hidden_dim": 64, "out_dim": 2, "n_heads": 4, "feat_drop": 0.1,
         "graph_pooling_type": "mean"}
OPTIM = {"opt_method": "ADAM", "lr": 0.0001, "weight_decay": 0.005}
B_PER_DEV, N, D, T, RADIUS = 2, 64, 32, 6, 4


def _trainable(config_gnn, seed, device, lattice=False):
    from .. import convert
    from ..config import parse_gnn_model, parse_lattice_twin, parse_optimizer

    model = (parse_lattice_twin(config_gnn) if lattice
             else parse_gnn_model(config_gnn)[0])
    convert.init_flax_like_(model, seed)
    model.to(device)
    return model, parse_optimizer(OPTIM, model.parameters())


def _finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def dryrun_steps(mesh, seed: int = 0) -> Dict:
    """One step of every parallel path on this rank of `mesh`'s world;
    every rank calls it. Returns the losses and the collective counts of
    each path (rank 0 also runs the single-process featurizer and
    construction over `featurizer_devices(mesh)`)."""
    from .. import collectives
    from ..config import parse_loss
    from ..graph.build import build_batch_device
    from ..graph.typed_graph import from_arrays
    from ..models.lattice import build_lattice_device
    from .big_graph import local_edges, make_big_graph_train_step
    from .dp import (make_dp_lattice_train_step, make_dp_train_step,
                     place_state, rank_generator)
    from .mesh import shard_stacked

    dev, world = mesh.device, mesh.world
    loss_fcn = parse_loss({"loss": "CE"})
    rng = np.random.RandomState(seed)
    feats = rng.randn(world, B_PER_DEV, N, D).astype(np.float32)
    ntypes = rng.randint(0, T, (world, B_PER_DEV, N)).astype(np.int64)
    mask = np.ones((world, B_PER_DEV, N), dtype=bool)
    labels = rng.randint(0, 2, (world, B_PER_DEV))
    weights = np.ones((world, B_PER_DEV), np.float32)
    f, t, m = (shard_stacked(a, mesh) for a in (feats, ntypes, mask))
    y, w = shard_stacked(labels, mesh), shard_stacked(weights, mesh)
    out = {}

    # data parallelism: each rank its own bucket, gradients all-reduced
    model, opt = _trainable(HEAT4, 0, dev)
    place_state(model, opt, mesh)
    step = make_dp_train_step(model, opt, loss_fcn, True, mesh)
    g = build_batch_device(f, t, m, RADIUS, T)
    collectives.reset_counts()
    loss, probs = step(g, y, w, rank_generator(1, mesh))
    out["dp"] = (float(loss), collectives.counts())
    if not (_finite(loss) and _finite(probs)):
        raise FloatingPointError(f"dp step: loss {float(loss)}")

    # edge sharding: one graph, its edge store split over the ranks
    e_cap = 64 * world
    g1 = from_arrays(
        rng.randn(48, D).astype(np.float32),
        rng.randint(0, 48, e_cap - 16), rng.randint(0, 48, e_cap - 16),
        node_type=rng.randint(0, T, 48), esign=rng.randint(0, 2, e_cap - 16),
        sim=rng.randn(e_cap - 16), n_node_types=T, node_capacity=64,
        edge_capacity=e_cap)
    model, opt = _trainable(HEAT4, 3, dev)
    big = make_big_graph_train_step(model, opt, loss_fcn, True, mesh)
    gen = torch.Generator(device=dev).manual_seed(4)   # one seed: all ranks
    collectives.reset_counts()
    loss, probs = big(local_edges(g1, mesh),
                      torch.tensor([1], device=dev),
                      torch.tensor([1.0], device=dev), gen)
    out["big_graph"] = (float(loss), collectives.counts())
    if not (_finite(loss) and _finite(probs)):
        raise FloatingPointError(f"edge-sharded step: loss {float(loss)}")

    # the lattice form under data parallelism, with a few masked slots
    lat = build_lattice_device(f, t, m, RADIUS, T)
    drop = np.random.RandomState(11).rand(
        world, *lat.emask.shape) < 0.1
    lat = lat._replace(emask=lat.emask & ~shard_stacked(drop, mesh))
    model, opt = _trainable(HEAT4, 7, dev, lattice=True)
    place_state(model, opt, mesh)
    step = make_dp_lattice_train_step(model, opt, loss_fcn, mesh)
    collectives.reset_counts()
    loss, _ = step(lat, y, w, rank_generator(8, mesh))
    out["dp_lattice"] = (float(loss), collectives.counts())
    if not _finite(loss):
        raise FloatingPointError(f"dp lattice step: loss {float(loss)}")

    if mesh.rank == 0:
        out.update(_single_process_paths(featurizer_devices(mesh), rng))
    return out


def featurizer_devices(mesh):
    """The devices rank 0 shards the featurizer over: the host's cards
    (up to the world size), or the CPU once per rank."""
    if mesh.device.type == "cuda":
        n = min(mesh.world, torch.cuda.device_count())
        return tuple(torch.device("cuda", i) for i in range(n))
    return (mesh.device,) * mesh.world


def _single_process_paths(devices, rng) -> Dict:
    """The data-parallel featurizer and sharded construction: one process
    over `devices`, no collective."""
    from .. import collectives, convert
    from ..config import parse_gnn_model
    from ..graph.build import build_batch_device
    from ..models.featurizers import KimiaNet, make_cnn_encoder
    from .mesh import make_dp_featurizer

    n = len(devices)
    out = {}
    collectives.reset_counts()
    kimia = convert.init_flax_like_(KimiaNet(), 5).eval()
    variables = {k: v.detach() for k, v in
                 list(kimia.named_parameters()) + list(kimia.named_buffers())}
    fn = make_dp_featurizer(
        lambda v, p: torch.func.functional_call(kimia, v, (p,))[0], devices)
    patches = torch.from_numpy(rng.rand(n, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        feats = fn(variables, patches)
    if feats.shape != (n, 1024) or not _finite(feats):
        raise FloatingPointError(f"dp featurizer: {tuple(feats.shape)}")
    out["featurizer"] = collectives.counts()

    collectives.reset_counts()
    enc = make_cnn_encoder("kimia", {"feature_dim": 1024, "n_node_type": T},
                           {}, {}, with_typing=True, devices=devices)
    # four 96 x 96 patches a device: a slide of at least k + 1 nodes
    n_patch = 4 * n
    cfeats, ctypes = enc(rng.rand(n_patch, 96, 96, 3).astype(np.float32))
    if cfeats.shape != (n_patch, 1024) or ctypes.shape != (n_patch,) or (
            not _finite(cfeats)):
        raise FloatingPointError("sharded construction: features")
    dev = devices[0]
    cmodel, _ = parse_gnn_model(dict(HEAT4, in_dim=1024, feat_drop=0.0))
    convert.init_flax_like_(cmodel, 9).to(dev).eval()
    cg = build_batch_device(
        torch.from_numpy(cfeats[None]).to(dev),
        torch.from_numpy(ctypes[None].astype(np.int64)).to(dev),
        torch.ones((1, n_patch), dtype=torch.bool, device=dev), RADIUS, T)
    with torch.no_grad():
        logits = cmodel(cg)
    if logits.shape != (1, 2) or not _finite(logits):
        raise FloatingPointError("sharded construction: logits")
    out["construction"] = collectives.counts()
    return out


def summary(n: int, out: Dict) -> str:
    dp_loss, dp_counts = out["dp"]
    return (f"dryrun_multichip({n}): dp loss={dp_loss:.4f} "
            f"[collectives={dp_counts}], edge-sharded HEAT4 train step "
            f"loss={out['big_graph'][0]:.4f}, dp lattice train step "
            f"loss={out['dp_lattice'][0]:.4f}, dp featurizer ok "
            f"[collectives={out['featurizer']}], sharded construction "
            f"(two-CNN patch stream -> graph -> logits) ok "
            f"[collectives={out['construction']}]")


def check(out: Dict) -> None:
    """The collective census: the data-parallel steps all-reduce and
    nothing else; the single-process paths issue nothing."""
    for path in ("dp", "dp_lattice", "big_graph"):
        c = out[path][1]
        if c["broadcast"] or not c["all_reduce"]:
            raise AssertionError(f"{path}: collectives {c}")
    for path in ("featurizer", "construction"):
        if any(out[path].values()):
            raise AssertionError(f"{path}: collectives {out[path]}")


def _rank_main(rank: int, world: int, device: str, store: str) -> None:
    from .. import utils
    from .mesh import make_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device == "cuda":
        torch.cuda.set_device(rank)
        utils.set_cuda_numerics()
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(device=torch.device("cuda", rank)
                         if device == "cuda" else "cpu")
        out = dryrun_steps(mesh)
        if rank == 0:
            check(out)
            print(summary(world, out), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Spawn a world of `n_devices` processes (NCCL, one card each; gloo
    with device 'cpu') and run `dryrun_steps` in every one; a rank's
    exception fails the call. Fewer than `n_devices` cards raise."""
    import torch.multiprocessing as mp

    from ..utils import resolve_device

    if resolve_device(device).type == "cuda" and (
            torch.cuda.device_count() < n_devices):
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards, "
                           f"{torch.cuda.device_count()} visible; pass "
                           "device='cpu' for a gloo world on the CPU")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        mp.spawn(_rank_main, args=(n_devices, device,
                                   os.path.join(tmp, "store")),
                 nprocs=n_devices, join=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="processes in the world")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): NCCL, one card per process; "
                    "cpu: gloo")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
