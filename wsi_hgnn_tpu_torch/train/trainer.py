"""The GNN trainer (counterpart of wsi_hgnn_tpu/train/trainer.py).

It picks the training path as the JAX trainer does: the [B, N, k] lattice
twin when the model has one (HEAT2/HEAT4 with a mean/sum/max readout),
`train.lattice` is not off, every train graph packs into the lattice and
the JAX package's one-hot memory budget (`train.lattice_mem_budget`, 2 GiB)
fits the batch; the TypedGraph model otherwise. The JAX package's
`big_graph` mode (edge store sharded over several devices) is not ported:
where it would be chosen the trainer raises.

One step is the training augmentation (masks drawn from the trainer's
torch.Generator on the device), the forward pass in training mode
(dropout from the same generator; batch-global occupancy; GIN's running
statistics updated), the weighted loss, the backward pass and the
optimizer step. Homogeneous models see the untyped view of the batch.
Losses and probabilities stay on the device through an epoch and come to
the host once per epoch; each epoch then evaluates the test and
validation splits and writes a checkpoint version.

Every parameter has a gradient tensor before each optimizer step (zeros
where it took no part, such as the dead last layers of GAT, NTPoolGCN,
HetRGCN and HGT), because torch's optimizers skip a parameter whose
`.grad` is None while optax decays every leaf.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..config import (parse_gnn_model, parse_lattice_twin, parse_loss,
                      parse_optimizer)
from ..data.datasets import (GraphDataset, TCGACancerStageDataset,
                             TCGACancerTypingDataset)
from ..data.lattice_loader import (LatticeLoader, lattice_batch_for_budget,
                                   probe_lattice_and_capacities)
from ..data.loader import GraphLoader
from ..graph import transforms
from ..graph.typed_graph import TypedGraph, to_homogeneous
from ..models.lattice import (LatticeGraph, TrainMasks, apply_train_masks,
                              draw_train_masks)
from ..models.layers import DropSource
from ..profiling import GLOBAL_TIMER
from ..utils import resolve_device, set_cuda_numerics, to_numpy, to_torch
from .checkpoint import (CheckpointManager, generator_key,
                         load_opt_state_from_flax, opt_state_to_flax,
                         set_generator_state)
from .evaluator import SplitEvaluator, lattice_enabled
from .metrics import accuracy, metrics

# the reference's augmentation probability (DropNode, DropEdge, FeatMask)
AUG_P = 0.5


def select_dataset(config_data: Dict, split_path: str, type_: str):
    """(dataset, average) for a split: the reference's dataset switch.
    Its trainer and evaluator tables disagree on TCGA cancer
    classification: 'binary' for the train split, 'macro' for eval
    splits; both are kept, keyed on type_."""
    name = config_data["dataset"]
    task = config_data.get("task", "")
    tcga = name in ("COAD", "BRCA", "ESCA")
    normal_path = config_data.get("normal_path", "") if tcga else ""
    if task == "cancer staging":
        return TCGACancerStageDataset(split_path, normal_path, type_), "macro"
    if task == "cancer typing":
        return TCGACancerTypingDataset(split_path, normal_path, type_), "binary"
    average = "macro" if (type_ == "eval" and tcga) else "binary"
    return GraphDataset(split_path, normal_path, name, type_), average


def _step(model, optimizer, loss_fn, forward, labels, weights):
    """Forward, weighted loss, backward, zero grads for parameters that
    took no part, optimizer step. Returns (loss, softmax probabilities)."""
    model.train()
    optimizer.zero_grad(set_to_none=False)
    logits = forward()
    loss = loss_fn(logits, labels, weights)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach(), torch.softmax(logits.detach(), -1)


def lattice_train_step(model, optimizer: torch.optim.Optimizer, loss_fn,
                       g: LatticeGraph, labels: torch.Tensor,
                       weights: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       masks: Optional[TrainMasks] = None,
                       drop_masks: Optional[List[torch.Tensor]] = None):
    """One lattice training step in place on `model` and `optimizer`. The
    augmentation masks and the dropout masks are drawn from `generator`
    unless given. Returns (loss, softmax probabilities), on the device."""
    if masks is None:
        masks = draw_train_masks(g, generator, AUG_P)
    g = apply_train_masks(g, masks)
    return _step(model, optimizer, loss_fn,
                 lambda: model(g, generator=generator, drop_masks=drop_masks),
                 labels, weights)


def typed_train_step(model, optimizer: torch.optim.Optimizer, loss_fn,
                     g: TypedGraph, labels: torch.Tensor,
                     weights: torch.Tensor, is_hetero: bool,
                     generator: Optional[torch.Generator] = None,
                     masks: Optional[transforms.TrainMasks] = None,
                     drops: Optional[DropSource] = None):
    """One TypedGraph training step (the JAX trainer's _train_step_impl)
    in place on `model` and `optimizer`: the untyped view for homogeneous
    models, the augmentation, the forward in training mode. The
    augmentation masks are drawn from `generator` unless given, and the
    dropout masks come from `drops` (by default drawn from `generator`).
    Returns (loss, softmax probabilities), on the device."""
    if not is_hetero:
        g = to_homogeneous(g)
    if masks is None:
        masks = transforms.draw_train_masks(g, generator, AUG_P)
    g = transforms.apply_train_masks(g, masks)
    if drops is None:
        drops = DropSource(generator)
    return _step(model, optimizer, loss_fn, lambda: model(g, drops),
                 labels, weights)


class GNNTrainer:
    """Trains the config's model on its train split, per the reference's
    epoch loop, on `device` (the card unless 'cpu' is asked for). Resumes
    from the latest checkpoint version when there is one."""

    def __init__(self, config: Dict, seed: int = 611, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        self.config = config
        self.config_data = config["datasets"]
        self.config_train = config["train"]
        self.config_optim = config["optimizer"]
        config_gnn = config["GNN"]

        self.checkpoint_manager = CheckpointManager(config["checkpoint"]["path"])
        self.n_epoch = self.config_train["num_epochs"]
        self.batch_size = self.config_train["batch_size"]

        self.valid_path = self.config_data["valid_path"]
        self.eval_path = self.config_data["eval_path"]
        self.train_data, self.average = select_dataset(
            self.config_data, self.config_data["train_path"], "train")
        cap_n, cap_e, probe = probe_lattice_and_capacities(
            self.train_data, self.batch_size, max_pad_ratio=float(
                self.config_train.get("lattice_pad_ratio", 1.5)))

        n_dev = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        threshold = self.config_train.get("big_graph_edge_threshold",
                                          1_000_000)
        if n_dev > 1 and cap_e > threshold:
            raise NotImplementedError(
                f"batch edge capacity {cap_e} > big_graph_edge_threshold "
                f"{threshold} with {n_dev} devices selects the JAX package's "
                "big-graph mode (edges sharded over devices), which is not "
                "ported yet (ROADMAP.md item 15)")

        typed, self.is_hetero = parse_gnn_model(config_gnn)
        twin = (parse_lattice_twin(config_gnn)
                if self.is_hetero and lattice_enabled(config) else None)
        budget = self.config_train.get("lattice_mem_budget", 2 << 30)
        self.lattice = (twin is not None and probe is not None
                        and lattice_batch_for_budget(
                            probe[0], probe[1], budget,
                            max_batch=self.batch_size) == self.batch_size)
        self.model = twin if self.lattice else typed
        convert.init_flax_like_(self.model, seed)
        self.model.to(self.device)
        self.optimizer = parse_optimizer(self.config_optim,
                                         self.model.parameters())
        self.loss_fcn = parse_loss(self.config_train)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        if self.lattice:
            self.k, lat_cap_n = probe
            self.loader = LatticeLoader(self.train_data, self.batch_size,
                                        self.k, lat_cap_n, shuffle=True,
                                        seed=seed, device=self.device)
            typed.to(self.device)
            self.splits = SplitEvaluator(config, typed, True, twin,
                                         self.device)
            print(f"lattice mode: k={self.k} (masked padding for shorter "
                  f"rows), node capacity {lat_cap_n}")
        else:
            self.loader = GraphLoader(self.train_data, self.batch_size,
                                      shuffle=True, seed=seed,
                                      node_capacity=cap_n,
                                      edge_capacity=cap_e,
                                      device=self.device)
            self.splits = SplitEvaluator(config, typed, self.is_hetero, None,
                                         self.device)
            print(f"TypedGraph mode: batch capacities {cap_n} nodes, "
                  f"{cap_e} edges")
        self._eval_data: Dict[str, tuple] = {}
        self.start_epoch = 0
        if self.checkpoint_manager.version > 0:
            self._resume()

    def _resume(self) -> None:
        """Params, running statistics, optimizer state and generator of
        the latest version (written by either package)."""
        try:
            state = self.checkpoint_manager.load_model_raw()
            variables = {"params": state["params"]}
            if state.get("batch_stats"):
                variables["batch_stats"] = state["batch_stats"]
            convert.load_flax_variables(self.model, variables)
            load_opt_state_from_flax(self.optimizer, self.model,
                                     state["opt_state"], self.config_optim)
            set_generator_state(self.generator, state["rng"])
        except (FileNotFoundError, KeyError, ValueError) as e:
            print(f"Could not resume from checkpoint ({e}); starting fresh")
            return
        self.start_epoch = self.checkpoint_manager.version
        print(f"Resumed from checkpoint v{self.start_epoch}")

    def train_step(self, g, labels: torch.Tensor, weights: torch.Tensor):
        if self.lattice:
            return lattice_train_step(self.model, self.optimizer,
                                      self.loss_fcn, g, labels, weights,
                                      self.generator)
        return typed_train_step(self.model, self.optimizer, self.loss_fcn,
                                g, labels, weights, self.is_hetero,
                                self.generator)

    def train(self, log_every: int = 1) -> Dict[str, float]:
        print("Start training GNN")
        last_stats: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.n_epoch):
            t0 = time.time()
            loss_dev, prob_dev, labels_host, weights_host = [], [], [], []
            for g, labels, weights in self.loader:
                with GLOBAL_TIMER.stage("train/step"):
                    loss, prob = self.train_step(
                        g, to_torch(labels, self.device, torch.int64),
                        to_torch(weights, self.device))
                loss_dev.append(loss)
                prob_dev.append(prob)
                labels_host.append(labels)
                weights_host.append(weights)

            with GLOBAL_TIMER.stage("train/epoch_fetch"):
                res = float(torch.stack(loss_dev).sum())
                prob_all = to_numpy(torch.cat(prob_dev))
            labels_all = np.concatenate(labels_host)
            real = np.concatenate(weights_host) > 0
            # per-batch mean of batch accuracies, like the reference
            accs, off = [], 0
            for w in weights_host:
                r = w > 0
                accs.append(accuracy(prob_all[off:off + len(w)][r],
                                     labels_all[off:off + len(w)][r]))
                off += len(w)
            acc = float(np.mean(accs))
            precision, recall, f1, train_auc = metrics(
                prob_all[real], labels_all[real], average=self.average)

            with GLOBAL_TIMER.stage("train/eval_test"):
                test_m = self.evaluate_split(self.eval_path)
            with GLOBAL_TIMER.stage("train/eval_val"):
                val_m = self.evaluate_split(self.valid_path)

            epoch_stats = {
                "Epoch": epoch + 1,
                "Train Loss: ": res,
                "Training Accuracy": acc,
                "Training Precision": precision,
                "Training Recall": recall,
                "Training F1": f1,
                "Training AUC": train_auc,
                "Validation Accuracy": val_m["acc"],
                "Validation F1": val_m["f1"],
                "Validation Precision": val_m["precision"],
                "Validation Recall": val_m["recall"],
                "Validation AUC": val_m["auc"],
                "Testing Accuracy": test_m["acc"],
                "Testing F1": test_m["f1"],
                "Testing Precision": test_m["precision"],
                "Testing Recall": test_m["recall"],
                "Testing AUC": test_m["auc"],
            }
            self.checkpoint_manager.write_new_version(
                self.config, self.checkpoint_state(), epoch_stats)
            self.checkpoint_manager.remove_old_version()
            last_stats = epoch_stats
            if log_every and (epoch % log_every == 0):
                print(f"Epoch {epoch} | loss {res:.4f} | acc {acc:.4f} | "
                      f"val auc {val_m['auc']:.4f} | test auc "
                      f"{test_m['auc']:.4f} | {time.time() - t0:.2f}s")
        return last_stats

    def checkpoint_state(self) -> Dict:
        """What a checkpoint version holds, as flax-layout numpy trees
        (the generator is reseeded with the key written under `rng`)."""
        return {
            "params": convert.params_to_flax(
                self.model, dict(self.model.named_parameters())),
            "batch_stats": convert.to_flax_variables(self.model).get(
                "batch_stats", {}),
            "opt_state": opt_state_to_flax(self.optimizer, self.model,
                                           self.config_optim),
            "rng": generator_key(self.generator),
        }

    def evaluate_split(self, split_path: str) -> Dict[str, float]:
        if split_path not in self._eval_data:
            self._eval_data[split_path] = select_dataset(
                self.config_data, split_path, "eval")
        data, average = self._eval_data[split_path]
        return self.splits(data, average)
