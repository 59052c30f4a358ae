"""Training epochs of the program's trainer on a seeded cohort.

Set-up writes the cohort under TMPDIR: slides of log-spaced sizes (every
seed the same sizes), seeded features and node types, graphs by the
benchmark's own plain KNN and Pearson, each a compressed `.npz` in the
port's format, with the split lists and a normal list that label them.
It builds `GNNTrainer(config)` on it, loads the seeded weights into the
trainer's model, and drives the trainer's own step loop (`for g, labels,
weights in trainer.loader: trainer.train_step(...)`, GNNTrainer.train's
loop without its epoch-end evaluation and checkpoint) through the first
`ref_steps` steps, keeping what the comparison needs. The window goes on
with that same trainer and loader, epoch after epoch, and closes with a
synchronise after the step that crosses --seconds.

Correct: the reference (reference/train.py) runs the same first steps
from the same weights on the same batches and random draws. Compared,
leaves whose first reference gradient is under a thousandth of the
median leaf's left out (they move by weight decay and round-off alone):
  loss_gap    the largest relative gap of a step's loss
  grad_gap    the largest gap between the program's and the reference's
              norm of a leaf's first gradient as Adam got it (from Adam's
              first moment after step 1), over the larger of the
              reference's norm of that leaf and of the median leaf
  change_gap  the same for each leaf's change over the first steps
"""
from __future__ import annotations

import shutil
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from common import (Outcome, Trace, checks_from, free_device_memory,
                    log_spaced_sizes, now, sub_seed)
import models

BETA1 = 0.9


def write_cohort(ctx, root: Path):
    """The cohort's files; returns (train paths, labels, sizes [(n, e)])."""
    import torch

    from reference.gnn import slide_edges
    from reference.precision import Prec

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    dim = int(cfg["GNN"]["in_dim"])
    n_types = int(cfg["graph"]["n_node_types"])
    radius = int(cfg["graph"]["radius"])
    sizes = log_spaced_sizes(p["min_nodes"], p["max_nodes"], p["slides"])
    rng = np.random.default_rng(sub_seed(ctx.seed, "cohort"))
    sizes = [sizes[i] for i in rng.permutation(len(sizes))]
    normal = set(rng.permutation(len(sizes))[:len(sizes) // 2].tolist())
    gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, "cohort-feat"))
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    prec = Prec("f32")
    jobs, paths, labels, ne = [], [], [], []
    for i, n in enumerate(sizes):
        protos = torch.randn((16, dim), generator=gen, device=dev)
        which = torch.randint(0, 16, (n,), generator=gen, device=dev)
        feat = protos[which] + 0.5 * torch.randn((n, dim), generator=gen, device=dev)
        ntype = torch.randint(0, n_types, (n,), generator=gen, device=dev)
        src, dst, esign, sim = slide_edges(feat, radius, prec)
        name = f"TCGA-BM-{i:04d}-01A-slide.npz"
        arrays = dict(feat=feat.cpu().numpy(), src=src.int().cpu().numpy(),
                      dst=dst.int().cpu().numpy(),
                      node_type=ntype.int().cpu().numpy(),
                      esign=esign.int().cpu().numpy(), sim=sim.cpu().numpy(),
                      n_node_types=np.int32(n_types), is_hetero=np.bool_(True))
        jobs.append((root / name, arrays))
        paths.append(str(root / name))
        labels.append(0 if i in normal else 1)
        ne.append((n, len(arrays["src"])))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: save_npz(*job), jobs))
    (root / "train.txt").write_text("\n".join(paths) + "\n")
    (root / "normal.txt").write_text(
        "\n".join(f"TCGA-BM-{i:04d}-01A" for i in sorted(normal)) + "\n")
    return paths, labels, ne


def save_npz(path: Path, arrays) -> None:
    """np.savez_compressed's layout (one .npy member per key, deflated),
    at zlib's fastest level: the program reads it as any `.npz`."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        for key, value in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value),
                                          allow_pickle=False)


def trainer_config(cfg, root: Path):
    return {"GNN": dict(cfg["GNN"]), "train": dict(cfg["train"]),
            "optimizer": dict(cfg["optimizer"]),
            "datasets": {**cfg["datasets"], "train_path": str(root / "train.txt"),
                         "valid_path": str(root / "train.txt"),
                         "eval_path": str(root / "train.txt"),
                         "normal_path": str(root / "normal.txt")},
            "checkpoint": {"path": str(root / "checkpoint")}}


def epochs(loader):
    while True:
        for item in loader:
            yield item


def run(ctx) -> Outcome:
    import torch

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.train.trainer import GNNTrainer
    from wsi_hgnn_tpu_torch.utils import to_torch

    from reference import train as ref_train
    from reference.precision import Prec
    from reference.weights import to_numpy

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    root = ctx.scratch
    try:
        paths, labels, ne = write_cohort(ctx, root)
        ctx.log(f"set-up: cohort written at {now() - ctx.t_start:.2f} s")
        seed = sub_seed(ctx.seed, "trainer")
        trainer = GNNTrainer(trainer_config(cfg, root), seed=seed, device=dev)
        ctx.log(f"set-up: trainer built at {now() - ctx.t_start:.2f} s")
        if bool(trainer.lattice) != bool(p["lattice"]):
            raise RuntimeError(f"the trainer chose lattice={trainer.lattice}, "
                               f"the cell expects lattice={p['lattice']}")
        gnn_w = models.gnn_weights(cfg, ctx.seed, dev)
        convert.load_flax_variables(trainer.model, {"params": to_numpy(gnn_w)["params"]})
        model, opt = trainer.model, trainer.optimizer
        named = dict(model.named_parameters())
        batch = int(cfg["train"]["batch_size"])
        order = ref_train.epoch_batches  # the loader's visiting order
        plan_rng = np.random.RandomState(seed)
        plan = []

        def next_sizes():
            if not plan:
                plan.extend(order(len(paths), batch, plan_rng))
            return [ne[i] for i in plan.pop(0)]

        it = epochs(trainer.loader)
        losses, adam1, after = [], None, None
        n_ref = int(p["ref_steps"])

        def step(g, lab, wts):
            return trainer.train_step(g, to_torch(lab, dev, torch.int64),
                                      to_torch(wts, dev))

        for s in range(n_ref):
            g, lab, wts = next(it)
            next_sizes()
            loss, _ = step(g, lab, wts)
            losses.append(float(loss))
            if s == 0:
                # a step that left the optimizer untouched has no moment:
                # it reads as a zero gradient
                adam1 = convert.params_to_flax(model, {
                    k: opt.state[v].get("exp_avg", torch.zeros_like(v)
                                        ).detach().clone() / (1 - BETA1)
                    for k, v in named.items()})
        after = convert.params_to_flax(model, {
            k: v.detach().clone() for k, v in named.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ctx.log(f"set-up: first {n_ref} steps done at {now() - ctx.t_start:.2f} s")
        trace = Trace(ctx.trace)
        steps = slides = 0
        wait = 0.0
        window_losses, traced_sizes, step_ms, wait_ms = [], [], [], []
        t0 = now()
        setup_s = t0 - ctx.t_start
        trace.start()
        while True:
            with trace.span("loader next"):
                t = now()
                g, lab, wts = next(it)
                t1 = now()
                wait += t1 - t
            sizes = next_sizes()
            with trace.span("train_step"):
                loss, _ = step(g, lab, wts)
            wait_ms.append((t1 - t) * 1e3)
            step_ms.append((now() - t1) * 1e3)
            window_losses.append(loss)
            real = [sz for sz, w in zip(sizes, wts) if w > 0]
            slides += len(real)
            steps += 1
            if trace.active:
                traced_sizes += real
                if now() - t0 >= float(p["trace_s"]):
                    trace.stop()
            if now() - t0 >= ctx.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window_s = now() - t0
        trace.stop()
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
        q = lambda v: " / ".join(f"{x:.1f}" for x in np.quantile(v, [0.5, 0.9, 1.0]))  # noqa: E731
        ctx.log(f"window: {steps} steps, {slides} slides in {window_s:.3f} s; "
                f"host ms a step in train_step p50/p90/max {q(step_ms)}, "
                f"in loader next() {q(wait_ms)}")
        record = {"window_s": window_s, "loader_wait_s": wait, "steps": steps,
                  "trace": trace.result, "model": p["model"],
                  "traced": {"sizes": traced_sizes}, "gnn": dict(cfg["GNN"])}
        del trainer, model, opt, named, g, it
        free_device_memory()

        # ---- correct ----
        ref = ref_train.reference_steps(
            p["model"], gnn_w, cfg["GNN"], cfg["optimizer"], paths, labels,
            batch, seed, n_ref, Prec("f32"), dev)
        values = compare(losses, adam1, after, gnn_w, ref)
        control = {}
        if ctx.control:
            tf = ref_train.reference_steps(
                p["model"], gnn_w, cfg["GNN"], cfg["optimizer"], paths, labels,
                batch, seed, n_ref, Prec("tf32"), dev)
            control = {f"tf32.{k}": v for k, v in
                       compare_ref(tf, gnn_w, ref).items()}
            if batch > 1:
                half = ref_train.reference_steps(
                    p["model"], gnn_w, cfg["GNN"], cfg["optimizer"], paths,
                    labels, batch, seed, n_ref, Prec("f32"), dev,
                    half_batch=True)
                control.update({f"half_batch.{k}": v for k, v in
                                compare_ref(half, gnn_w, ref).items()})
        free_device_memory()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return Outcome(
        attempted=steps, failed=failed,
        end_to_end={"setup_s": setup_s, "train_slides_per_s": slides / window_s},
        record=record, checks=checks_from(values, ctx.workload["limits"]),
        memory_peak_bytes=peak, control_checks=control)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _norm(x) -> float:
    import torch

    if isinstance(x, torch.Tensor):
        return float(x.detach().double().norm())
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def leaf_gap(got: dict, want: dict, kept) -> float:
    """Largest | |got leaf| - |want leaf| | over max(|want leaf|, median
    |want leaf|), over the kept leaves."""
    norms = {k: _norm(want[k]) for k in kept}
    med = float(np.median(list(norms.values())))
    return max(abs(_norm(got[k]) - norms[k]) / max(norms[k], med) for k in kept)


def kept_leaves(ref) -> list:
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's."""
    g = {k: _norm(v) for k, v in ref["grad1"].items()}
    med = float(np.median(list(g.values())))
    return [k for k, v in g.items() if v >= 1e-3 * med]


def _leaves(tree, prefix="params/") -> dict:
    """{path: float64 array} of a flax-layout tree (program, numpy) or of
    the reference's {path: tensor}."""
    if all(not isinstance(v, dict) for v in tree.values()):
        return {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                              np.float64) for k, v in tree.items()}
    return {prefix + k: np.asarray(v, np.float64) for k, v in _flat(tree).items()}


def compare(losses, adam1, after, gnn_w, ref) -> dict:
    """The three numbers: one run's first losses, first Adam inputs and
    parameters after the first steps against the reference's."""
    w0 = {k: v.detach().double().cpu().numpy() for k, v in _flat(gnn_w).items()
          if k.startswith("params/")}
    kept = kept_leaves(ref)
    after, ref_after = _leaves(after), _leaves(ref["params"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": leaf_gap(_leaves(adam1), ref["adam1"], kept),
        "change_gap": leaf_gap({k: after[k] - w0[k] for k in kept},
                               {k: ref_after[k] - w0[k] for k in kept}, kept),
    }


def compare_ref(other, gnn_w, ref) -> dict:
    """The same numbers with another reference run (a control or a planted
    fault) in the program's place."""
    return compare(other["losses"], other["adam1"], other["params"], gnn_w, ref)
