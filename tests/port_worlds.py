"""Process worlds for the port's multi-device tests on the CPU.

`run_world(case, world, tmp_path, inputs)` spawns `world` processes
(torch.multiprocessing, spawn), joins them into one gloo process group
through a file store under `tmp_path` (several pytest-xdist workers run
worlds at once, so no fixed TCP port), runs `case(mesh, inputs)` in each
and returns each rank's result. A rank's exception fails the call. Each
test file spawns ONE world, from a module-scoped fixture that runs all of
its cases, and its parametrised tests then assert one case each.

The cases live here, in a module that imports torch and the port but no
JAX: every spawned process imports it. Inputs and results are numpy (the
flax-layout trees `convert` reads and writes).
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch

# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _entry(rank: int, world: int, store: str, case, inputs, out_dir: str,
           device: str = "cpu"):
    import torch.distributed as dist

    from wsi_hgnn_tpu_torch.parallel import make_mesh
    from wsi_hgnn_tpu_torch.utils import set_cuda_numerics

    torch.set_num_threads(1)
    if device != "cpu":
        set_cuda_numerics()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = case(make_mesh(device=device), inputs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(case, world: int, tmp_path: Path, inputs=None,
              device: str = "cpu"):
    """[result of rank 0, ..., rank world-1] of `case(mesh, inputs)`;
    every rank's mesh is on `device` ('cuda': all ranks on one card)."""
    import torch.multiprocessing as mp

    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(world, str(tmp_path / "store"), case, inputs,
                           str(tmp_path), device), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def run_cases(mesh, cases):
    """Every (name, function, inputs) of `cases` on this rank, in order:
    {name: result}."""
    return {name: fn(mesh, inputs) for name, fn, inputs in cases}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def grads_flax(model):
    from wsi_hgnn_tpu_torch import convert

    return flat(convert.params_to_flax(model, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()}))


def params_flax(model):
    from wsi_hgnn_tpu_torch import convert

    return flat(convert.params_to_flax(model, dict(model.named_parameters())))


def port_model(spec, variables=None):
    """A port model from (kind, kwargs) or a GNN config dict, with the
    given flax variables (or none)."""
    from wsi_hgnn_tpu_torch import convert, models
    from wsi_hgnn_tpu_torch.config import parse_gnn_model

    if isinstance(spec, dict):
        model, _ = parse_gnn_model(spec)
    else:
        kind, kwargs = spec
        model = getattr(models, kind)(**kwargs)
    if variables is not None:
        convert.load_flax_variables(model, variables)
    return model


def host_graph(arrays: dict):
    """A host TypedGraph from a dict of arrays and its static fields."""
    from wsi_hgnn_tpu_torch.graph.typed_graph import TypedGraph

    return TypedGraph(**arrays)


def device_graph_arrays(g) -> dict:
    """A device TypedGraph's arrays on the host, as host_graph's dict."""
    arrays = {f: getattr(g, f).cpu().numpy() for f in (
        "feat", "node_type", "node_graph", "node_mask", "src", "dst",
        "esign", "sim", "edge_mask")}
    return dict(arrays, n_graphs=g.n_graphs, n_node_types=g.n_node_types,
                n_edge_types=g.n_edge_types)


def slide_arrays(arrays: dict, r: int, n: int) -> dict:
    """Slide r of a build_batch_device batch of equal n-node slides (nodes
    and src-major edges contiguous per slide) as one slide's arrays."""
    e = arrays["src"].shape[0] // arrays["n_graphs"]
    nodes, edges = slice(r * n, (r + 1) * n), slice(r * e, (r + 1) * e)
    out = {k: arrays[k][nodes] for k in ("feat", "node_type", "node_mask")}
    out.update({k: arrays[k][edges] for k in ("esign", "sim", "edge_mask")})
    return dict(out, src=arrays["src"][edges] - r * n,
                dst=arrays["dst"][edges] - r * n,
                node_graph=arrays["node_graph"][nodes] * 0, n_graphs=1,
                n_node_types=arrays["n_node_types"],
                n_edge_types=arrays["n_edge_types"])


# ---------------------------------------------------------------------------
# edge sharding (tests/test_torch_big_graph.py)
# ---------------------------------------------------------------------------


def big_forward(mesh, inp):
    """The sharded evaluation forward's logits."""
    from wsi_hgnn_tpu_torch.parallel import shard_edges, sharded_apply

    model = port_model(inp["model"], inp["variables"])
    g = host_graph(inp["graph"])
    with torch.no_grad():
        out = sharded_apply(model, mesh, inp["is_hetero"])(
            shard_edges(g, mesh.world))
    return out.numpy()


def big_forward_grads(mesh, inp):
    """Logits of the sharded forward and the gradients of their sum,
    averaged over the group (the single-device gradients)."""
    from wsi_hgnn_tpu_torch.collectives import average_gradients
    from wsi_hgnn_tpu_torch.parallel import shard_edges, sharded_apply

    model = port_model(inp["model"], inp["variables"])
    g = host_graph(inp["graph"])
    out = sharded_apply(model, mesh, inp["is_hetero"])(
        shard_edges(g, mesh.world))
    out.sum().backward()
    average_gradients(model.parameters(), mesh.group, mesh.world)
    return out.detach().numpy(), grads_flax(model)


def big_train_step(mesh, inp):
    """One edge-sharded step without augmentation, SGD(lr 1e-3): the
    loss, the averaged gradients and the parameters after it."""
    from wsi_hgnn_tpu_torch.config import parse_loss
    from wsi_hgnn_tpu_torch.parallel import (local_edges,
                                             make_big_graph_train_step)

    model = port_model(inp["model"], inp["variables"])
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    step = make_big_graph_train_step(model, opt, parse_loss({"loss": "CE"}),
                                     inp["is_hetero"], mesh, augment=False)
    gen = torch.Generator().manual_seed(2)
    loss, probs = step(local_edges(host_graph(inp["graph"]), mesh),
                       torch.as_tensor(inp["labels"], dtype=torch.int64),
                       torch.as_tensor(inp["weights"]), gen)
    return (float(loss), probs.numpy(), grads_flax(model),
            params_flax(model))


def big_train_augmented(mesh, inp):
    """Five augmented edge-sharded steps: the losses and the parameters
    (every rank's must agree)."""
    from wsi_hgnn_tpu_torch.config import parse_loss
    from wsi_hgnn_tpu_torch.parallel import (local_edges,
                                             make_big_graph_train_step)

    model = port_model(inp["model"], inp["variables"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_big_graph_train_step(model, opt, parse_loss({"loss": "CE"}),
                                     True, mesh)
    gen = torch.Generator().manual_seed(5)
    g = local_edges(host_graph(inp["graph"]), mesh)
    labels = torch.tensor([0, 1])
    weights = torch.tensor([1.0, 1.0])
    losses = [float(step(g, labels, weights, gen)[0]) for _ in range(5)]
    return losses, params_flax(model)


def big_per_graph_occupancy(mesh, inp):
    """HEAT4 on a per-graph-occupancy batch: the sharded forward and, on
    every rank, the unsharded one."""
    from wsi_hgnn_tpu_torch.parallel import shard_edges, sharded_apply

    model = port_model(inp["model"], inp["variables"]).eval()
    g = host_graph(inp["graph"]).replace(per_graph_occupancy=True)
    with torch.no_grad():
        sharded = sharded_apply(model, mesh, True)(shard_edges(g, mesh.world))
        single = model(g.to_torch(torch.device("cpu")))
    return sharded.numpy(), single.numpy()


def allreduce_rule(mesh, inp):
    """d(5 * sum over ranks of w * (rank + 1))/dw on this rank, before and
    after averaging over the group."""
    from wsi_hgnn_tpu_torch.collectives import (all_reduce_sum,
                                                average_gradients)

    w = torch.ones((), requires_grad=True)
    (5.0 * all_reduce_sum(w * (mesh.rank + 1), mesh.group)).backward()
    before = float(w.grad)
    average_gradients([w], mesh.group, mesh.world)
    return before, float(w.grad)


# ---------------------------------------------------------------------------
# data parallelism (tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------


def dp_step(mesh, inp):
    """One data-parallel step on this rank's bucket (built from its row
    of the stacked features): the loss, the parameters and the running
    statistics after it."""
    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import (parse_gnn_model,
                                           parse_lattice_twin, parse_loss,
                                           parse_optimizer)
    from wsi_hgnn_tpu_torch.graph.build import build_batch_device
    from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
    from wsi_hgnn_tpu_torch.parallel import (make_dp_lattice_train_step,
                                             make_dp_train_step, place_state,
                                             rank_generator, shard_stacked)

    cfg = inp["config"]
    lattice = inp.get("lattice", False)
    if lattice:
        model, is_hetero = parse_lattice_twin(cfg["GNN"]), True
    else:
        model, is_hetero = parse_gnn_model(cfg["GNN"])
    # rank 0 alone loads the weights; place_state broadcasts them
    if mesh.rank == 0:
        convert.load_flax_variables(model, inp["variables"])
    opt = parse_optimizer(cfg["optimizer"], model.parameters())
    place_state(model, opt, mesh)
    loss_fcn = parse_loss(cfg["train"])
    f, t, m = (shard_stacked(inp[k], mesh) for k in ("feats", "ntypes",
                                                       "mask"))
    y, w = shard_stacked(inp["labels"], mesh), shard_stacked(inp["weights"],
                                                            mesh)
    build = build_lattice_device if lattice else build_batch_device
    kwargs = {} if is_hetero or lattice else {"add_self_loops": True}
    g = build(f, t, m, inp["radius"], inp["n_types"], **kwargs)
    if lattice:
        step = make_dp_lattice_train_step(model, opt, loss_fcn, mesh,
                                          augment=inp["augment"])
    else:
        step = make_dp_train_step(model, opt, loss_fcn, is_hetero, mesh,
                                  augment=inp["augment"])
    loss, probs = step(g, y, w, rank_generator(inp.get("seed", 0), mesh))
    stats = convert.to_flax_variables(model).get("batch_stats", {})
    return float(loss), params_flax(model), flat(stats)


def card_steps(mesh, inp):
    """On this rank's card (SGD lr 1e-3, no augmentation): the edge-sharded
    HEAT4 and GCN steps on this rank's slice of inp['graph']'s edges,
    then the data-parallel GCN step on this rank's slide. {name: (loss,
    gradients by parameter name)}."""
    from wsi_hgnn_tpu_torch.config import parse_loss
    from wsi_hgnn_tpu_torch.parallel import (local_edges,
                                             make_big_graph_train_step,
                                             make_dp_train_step, place_state,
                                             rank_generator)

    dev, loss_fcn = mesh.device, parse_loss({"loss": "CE"})
    labels = torch.as_tensor(inp["labels"], device=dev)
    weights = torch.ones(len(labels), device=dev)

    def run(name, make_step, g, y, w, gen):
        model = port_model(inp["gnn"][name], inp["variables"][name]).to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        if make_step is make_dp_train_step:
            place_state(model, opt, mesh)
        loss, _ = make_step(model, opt, loss_fcn, name == "HEAT4", mesh,
                            augment=False)(g, y, w, gen)
        return float(loss), {n: p.grad.cpu().numpy()
                             for n, p in model.named_parameters()}

    out = {name: run(name, make_big_graph_train_step,
                     local_edges(host_graph(inp["graph"]), mesh), labels,
                     weights, torch.Generator(device=dev).manual_seed(0))
           for name in ("HEAT4", "GCN")}
    r = mesh.rank
    out["dp"] = run("GCN", make_dp_train_step,
                    host_graph(inp["slides"][r]).to_torch(dev),
                    labels[r:r + 1], weights[r:r + 1], rank_generator(0, mesh))
    return out


def trainer_big_graph(mesh, inp):
    """GNNTrainer on the synthetic cohort with the threshold at 1: the
    mode it picked, its last epoch's stats and the checkpoint versions
    on disk after rank 0 wrote them."""
    from wsi_hgnn_tpu_torch.config import load_config
    from wsi_hgnn_tpu_torch.train import GNNTrainer

    cfg = load_config(inp["config_path"])
    cfg["train"]["big_graph_edge_threshold"] = 1
    if mesh.rank:
        cfg["checkpoint"]["path"] = inp["other_ckpt"]
    trainer = GNNTrainer(cfg, seed=0, device="cpu")
    stats = trainer.train(log_every=0)
    return {"big_graph": trainer.big_graph, "lattice": trainer.lattice,
            "stats": stats,
            "versions": trainer.checkpoint_manager.version}


def trainer_mode_message(mesh, inp):
    """GNNTrainer built under the default threshold, which the synthetic
    cohort's batches stay under: whether it chose big-graph mode and what
    this rank printed."""
    import contextlib
    import io

    from wsi_hgnn_tpu_torch.config import load_config
    from wsi_hgnn_tpu_torch.train import GNNTrainer

    cfg = load_config(inp["config_path"])
    if mesh.rank:
        cfg["checkpoint"]["path"] = inp["other_ckpt"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = GNNTrainer(cfg, seed=0, device="cpu")
    return {"big_graph": trainer.big_graph, "printed": printed.getvalue()}


def dryrun(mesh, inp):
    """The dry run's steps on this rank."""
    from wsi_hgnn_tpu_torch.parallel.dryrun import check, dryrun_steps

    out = dryrun_steps(mesh)
    if mesh.rank == 0:
        check(out)
    return out
