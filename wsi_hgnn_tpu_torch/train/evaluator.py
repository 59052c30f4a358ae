"""Evaluation (counterpart of wsi_hgnn_tpu/train/evaluator.py): the
lattice path for HEAT models whose split packs into the lattice, the
TypedGraph path for every other model and split.

Both keep the reference's one-slide-at-a-time semantics where they
matter. A heterogeneous model computes relation and type occupancy over
the graph it is given, so on the TypedGraph path its slides come stacked
(per-slide capacities) and run one forward each; the lattice twin runs
with presence='graph'. Homogeneous models do not depend on the grouping
and run one flat batch of up to 8 slides. The JAX package caps lattice
eval batches by the size of a [B, N*k, N] one-hot matrix; the port
aggregates with O(E) index_add_ and builds no such matrix, so any split
the probe packs runs on the lattice path.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..config import parse_gnn_model, parse_lattice_twin
from ..data.lattice_loader import LatticeLoader, probe_lattice_and_capacities
from ..data.loader import GraphLoader
from ..graph.typed_graph import to_homogeneous, unstack
from ..utils import resolve_device, set_cuda_numerics, to_numpy
from .checkpoint import CheckpointManager
from .metrics import accuracy, metrics

EVAL_BATCH = 8


def lattice_enabled(config: Dict) -> bool:
    """`train.lattice` is not off (the JAX package's switch)."""
    pref = str(config.get("train", {}).get("lattice", "auto")).lower()
    return pref not in ("off", "false", "0")


def _pad_ratio(config: Dict) -> float:
    return float(config.get("train", {}).get("lattice_pad_ratio", 1.5))


def lattice_eval_loader(dataset, config: Dict, device: torch.device
                        ) -> Optional[LatticeLoader]:
    """An unshuffled lattice loader of up to 8 slides per batch over
    `dataset`, or None when the lattice path is off or a graph does not
    pack (the split then runs on the TypedGraph path)."""
    if not lattice_enabled(config):
        return None
    _, _, probe = probe_lattice_and_capacities(dataset, 1,
                                               max_pad_ratio=_pad_ratio(config))
    if probe is None:
        return None
    return LatticeLoader(dataset, EVAL_BATCH, probe[0], probe[1],
                         shuffle=False, device=device)


def make_eval_loader(dataset, is_hetero: bool, device: torch.device,
                     batch_size: int = EVAL_BATCH) -> GraphLoader:
    """The TypedGraph eval loader: stacked per-slide batches for
    heterogeneous models, flat batches for homogeneous ones, capacities
    from one scan of the split."""
    cap_n, cap_e, _ = probe_lattice_and_capacities(
        dataset, 1 if is_hetero else batch_size)
    return GraphLoader(dataset, batch_size, shuffle=False,
                       node_capacity=cap_n, edge_capacity=cap_e,
                       stacked=is_hetero, device=device)


def _inference(model, run):
    """run() in eval mode under inference_mode; the model's mode is
    restored afterwards (the trainer shares the model)."""
    training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            return run()
    finally:
        model.train(training)


def make_eval_fn(model, is_hetero: bool):
    """fwd(batch) -> softmax probabilities on the TypedGraph path: one
    forward per slide of a stacked batch (heterogeneous), or one forward
    of the flat batch on its untyped view (homogeneous)."""
    def fwd(g):
        if is_hetero:
            return _inference(model, lambda: torch.cat(
                [torch.softmax(model(s), -1) for s in unstack(g)]))
        return _inference(model, lambda: torch.softmax(
            model(to_homogeneous(g)), -1))

    return fwd


def make_lattice_eval_fn(model):
    """fwd(lattice batch) -> softmax probabilities, run with
    presence='graph' (restored afterwards)."""
    def fwd(g):
        presence = model.presence
        model.presence = "graph"
        try:
            return _inference(model, lambda: torch.softmax(model(g), -1))
        finally:
            model.presence = presence

    return fwd


def evaluate(loader, fwd, average: str) -> Dict[str, float]:
    """Run a loader through `fwd`; the reference metric pack."""
    probs, labels = [], []
    for g, lb, w in loader:
        p = to_numpy(fwd(g))
        real = w > 0
        probs.append(p[real])
        labels.append(lb[real])
    prob = np.concatenate(probs)
    label = np.concatenate(labels)
    precision, recall, f1, auc = metrics(prob, label, average=average)
    return {"acc": accuracy(prob, label), "f1": f1, "precision": precision,
            "recall": recall, "auc": auc, "prob": prob, "label": label}


class SplitEvaluator:
    """The eval path of one model over its splits, chosen per split as
    the JAX package chooses: the lattice twin (when the model has one,
    the lattice is on and the split packs) or the TypedGraph model.
    `typed` is the TypedGraph model, `twin` its lattice form (None: the
    TypedGraph path only). With a twin, the twin holds the weights and
    the TypedGraph model gets them before each of its evaluations."""

    def __init__(self, config: Dict, typed, is_hetero: bool, twin,
                 device: torch.device):
        self.config = config
        self.typed, self.is_hetero, self.twin = typed, is_hetero, twin
        self.device = device
        # the forward of each path: fwd[path](batch) -> probabilities
        self.fwd = {"typed": make_eval_fn(typed, is_hetero)}
        if twin is not None:
            self.fwd["lattice"] = make_lattice_eval_fn(twin)
        # one scan and loader per dataset object
        self._loaders = weakref.WeakKeyDictionary()

    def loader_of(self, dataset):
        """(path, loader) that evaluates `dataset`: 'lattice' with a
        LatticeLoader, or 'typed' with a GraphLoader."""
        entry = self._loaders.get(dataset)
        if entry is None:
            lat = (None if self.twin is None else
                   lattice_eval_loader(dataset, self.config, self.device))
            entry = (("lattice", lat) if lat is not None else
                     ("typed", make_eval_loader(dataset, self.is_hetero,
                                                self.device)))
            self._loaders[dataset] = entry
        return entry

    def __call__(self, dataset, average: str) -> Dict[str, float]:
        path, loader = self.loader_of(dataset)
        if path == "typed" and self.twin is not None:
            # the two forms of a HEAT model share names and shapes
            self.typed.load_state_dict(self.twin.state_dict())
        return evaluate(loader, self.fwd[path], average)


class HomoGraphEvaluator:
    """Checkpoint-loading evaluator with the reference's constructor
    contract: the model from the config, the latest checkpoint version
    restored (none raises), batch statistics included, the config's
    eval_path evaluated on the path the JAX evaluator would take."""

    def __init__(self, config: Dict, verbose: bool = True, device=None):
        from .trainer import select_dataset  # trainer imports this module

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        self.config = config
        self.config_data = config["datasets"]
        self.verbose = verbose
        self.checkpoint_manager = CheckpointManager(config["checkpoint"]["path"])
        self.model, self.is_hetero = parse_gnn_model(config["GNN"])
        self.test_data, self.average = select_dataset(
            self.config_data, self.config_data["eval_path"], "eval")
        self.variables = self.checkpoint_manager.restore_variables()
        convert.load_flax_variables(self.model, self.variables)
        self.model.to(self.device).eval()
        twin = parse_lattice_twin(config["GNN"]) if self.is_hetero else None
        if twin is not None:
            convert.load_flax_variables(twin, self.variables)
            twin.to(self.device).eval()
        self.twin = twin
        self.splits = SplitEvaluator(config, self.model, self.is_hetero, twin,
                                     self.device)
        self.last_metrics: Dict = {}

    def load_data(self, path):
        from .trainer import select_dataset

        data, self.average = select_dataset(self.config_data, path, "eval")
        return data

    def eval(self):
        m = self.splits(self.test_data, self.average)
        self.last_metrics = m
        if self.verbose:
            print("Metrics ==> [Acc: {acc:.4f} | F1: {f1:.4f} | Ps: "
                  "{precision:.4f} | Rec: {recall:.4f} | AUC: {auc:.4f}]"
                  .format(**m))
        return m["acc"], m["f1"], m["precision"], m["recall"], m["auc"]
