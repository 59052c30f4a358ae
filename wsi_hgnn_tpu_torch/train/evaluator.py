"""Evaluation on the lattice path (counterpart of the lattice parts of
wsi_hgnn_tpu/train/evaluator.py).

The model runs with presence='graph' (per-slide relation and type
occupancy, the reference's one-slide-at-a-time semantics), so metrics do
not depend on how slides are grouped into eval batches of up to 8. The
JAX package caps those batches by the size of a [B, N*k, N] one-hot
matrix; the port aggregates with O(E) index_add_ and builds no such
matrix, so any split the probe packs runs on the lattice path. A split
that does not pack needs the TypedGraph fallback, which is not ported.
"""
from __future__ import annotations

import weakref
from typing import Dict

import numpy as np
import torch

from .. import convert
from ..config import parse_gnn_model
from ..data.lattice_loader import LatticeLoader, probe_lattice_and_capacities
from ..utils import resolve_device, set_cuda_numerics, to_numpy
from .checkpoint import CheckpointManager
from .metrics import accuracy, metrics

EVAL_BATCH = 8


def lattice_enabled(config: Dict) -> bool:
    """`train.lattice` is not off (the JAX package's switch)."""
    pref = str(config.get("train", {}).get("lattice", "auto")).lower()
    return pref not in ("off", "false", "0")


def lattice_eval_loader(dataset, config: Dict, device: torch.device
                        ) -> LatticeLoader:
    """An unshuffled loader of up to 8 slides per batch over `dataset`,
    when the lattice path serves it; else NotImplementedError."""
    _, _, probe = probe_lattice_and_capacities(
        dataset, 1, max_pad_ratio=float(
            config.get("train", {}).get("lattice_pad_ratio", 1.5)))
    if probe is None or not lattice_enabled(config):
        raise NotImplementedError(
            "this split needs the TypedGraph evaluator (the lattice path is "
            "off, or a graph does not pack into the lattice), which is not "
            "ported yet (ROADMAP.md item 11)")
    return LatticeLoader(dataset, EVAL_BATCH, probe[0], probe[1],
                         shuffle=False, device=device)


def make_lattice_eval_fn(model):
    """fwd(graph) -> softmax probabilities, run with presence='graph' in
    eval mode under inference_mode; the model's own mode and presence are
    restored afterwards (the trainer shares the model)."""
    def fwd(g):
        presence, training = model.presence, model.training
        model.presence = "graph"
        model.eval()
        try:
            with torch.inference_mode():
                return torch.softmax(model(g), -1)
        finally:
            model.presence = presence
            model.train(training)

    return fwd


def evaluate_lattice(model, loader, average: str, fwd=None
                     ) -> Dict[str, float]:
    """Run a LatticeLoader through the model; the reference metric pack."""
    if fwd is None:
        fwd = make_lattice_eval_fn(model)
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


class HomoGraphEvaluator:
    """Checkpoint-loading evaluator with the reference's constructor
    contract: the model from the config, the latest checkpoint version
    restored (none raises), the config's eval_path evaluated."""

    def __init__(self, config: Dict, verbose: bool = True, device=None):
        from .trainer import select_dataset  # trainer imports this module

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        self.config = config
        self.config_data = config["datasets"]
        self.verbose = verbose
        self.checkpoint_manager = CheckpointManager(config["checkpoint"]["path"])
        self.model = parse_gnn_model(config["GNN"])
        self.test_data, self.average = select_dataset(
            self.config_data, self.config_data["eval_path"], "eval")
        self.variables = self.checkpoint_manager.restore_variables()
        convert.load_flax_variables(self.model, self.variables)
        self.model.to(self.device).eval()
        self._fwd = make_lattice_eval_fn(self.model)
        # one probe scan and loader per dataset object
        self._loaders = weakref.WeakKeyDictionary()
        self.last_metrics: Dict = {}

    def eval(self):
        loader = self._loaders.get(self.test_data)
        if loader is None:
            loader = lattice_eval_loader(self.test_data, self.config,
                                         self.device)
            self._loaders[self.test_data] = loader
        m = evaluate_lattice(self.model, loader, self.average, fwd=self._fwd)
        self.last_metrics = m
        if self.verbose:
            print("Metrics ==> [Acc: {acc:.4f} | F1: {f1:.4f} | Ps: "
                  "{precision:.4f} | Rec: {recall:.4f} | AUC: {auc:.4f}]"
                  .format(**m))
        return m["acc"], m["f1"], m["precision"], m["recall"], m["auc"]
