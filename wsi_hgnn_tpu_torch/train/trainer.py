"""The GNN trainer on the lattice path (counterpart of
wsi_hgnn_tpu/train/trainer.py for HEAT2/HEAT4).

One step is: the training augmentation (masks drawn from the trainer's
torch.Generator on the device), the forward pass with presence='batch',
the weighted loss, the backward pass and the optimizer step. Losses and
probabilities stay on the device through an epoch and come to the host
once per epoch; each epoch then evaluates the test and validation splits
(presence='graph') and writes a checkpoint version.

Every parameter has a gradient tensor before each optimizer step (zeros
where it took no part), because torch's optimizers skip a parameter whose
`.grad` is None while optax decays every leaf.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..config import parse_gnn_model, parse_loss, parse_optimizer
from ..data.datasets import (GraphDataset, TCGACancerStageDataset,
                             TCGACancerTypingDataset)
from ..data.lattice_loader import LatticeLoader, probe_lattice_and_capacities
from ..models.lattice import (LatticeGraph, TrainMasks, apply_train_masks,
                              draw_train_masks)
from ..profiling import GLOBAL_TIMER
from ..utils import resolve_device, set_cuda_numerics, to_numpy, to_torch
from .checkpoint import (CheckpointManager, generator_state,
                         load_opt_state_from_flax, opt_state_to_flax,
                         set_generator_state)
from .evaluator import (evaluate_lattice, lattice_enabled,
                        lattice_eval_loader, make_lattice_eval_fn)
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


def lattice_train_step(model, optimizer: torch.optim.Optimizer, loss_fn,
                       g: LatticeGraph, labels: torch.Tensor,
                       weights: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       masks: Optional[TrainMasks] = None,
                       drop_masks: Optional[List[torch.Tensor]] = None):
    """One training step in place on `model` and `optimizer`. The
    augmentation masks and the dropout masks are drawn from `generator`
    unless given. Returns (loss, softmax probabilities), on the device."""
    if masks is None:
        masks = draw_train_masks(g, generator, AUG_P)
    g = apply_train_masks(g, masks)
    model.train()
    optimizer.zero_grad(set_to_none=False)
    logits = model(g, generator=generator, drop_masks=drop_masks)
    loss = loss_fn(logits, labels, weights)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach(), torch.softmax(logits.detach(), -1)


class GNNTrainer:
    """Trains the config's lattice HEAT model on its train split, per the
    reference's epoch loop, on `device` (the card unless 'cpu' is asked
    for). Resumes from the latest checkpoint version when there is one."""

    def __init__(self, config: Dict, seed: int = 611, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        self.config = config
        self.config_data = config["datasets"]
        self.config_train = config["train"]
        self.config_optim = config["optimizer"]

        self.checkpoint_manager = CheckpointManager(config["checkpoint"]["path"])
        self.n_epoch = self.config_train["num_epochs"]
        self.batch_size = self.config_train["batch_size"]

        self.model = parse_gnn_model(config["GNN"])
        convert.init_flax_like_(self.model, seed)
        self.model.to(self.device)
        self.optimizer = parse_optimizer(self.config_optim,
                                         self.model.parameters())
        self.loss_fcn = parse_loss(self.config_train)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.valid_path = self.config_data["valid_path"]
        self.eval_path = self.config_data["eval_path"]
        self.train_data, self.average = select_dataset(
            self.config_data, self.config_data["train_path"], "train")
        _, _, probe = probe_lattice_and_capacities(
            self.train_data, self.batch_size, max_pad_ratio=float(
                self.config_train.get("lattice_pad_ratio", 1.5)))
        if probe is None or not lattice_enabled(config):
            raise NotImplementedError(
                "this dataset needs the TypedGraph trainer (the lattice path "
                "is off, or a graph does not pack into the lattice), which "
                "is not ported yet (ROADMAP.md item 11)")
        self.k, lat_cap_n = probe
        self.loader = LatticeLoader(self.train_data, self.batch_size, self.k,
                                    lat_cap_n, shuffle=True, seed=seed,
                                    device=self.device)
        print(f"lattice mode: k={self.k} (masked padding for shorter rows), "
              f"node capacity {lat_cap_n}")
        self._eval_fwd = make_lattice_eval_fn(self.model)
        self._eval_splits: Dict[str, tuple] = {}
        self.start_epoch = 0
        if self.checkpoint_manager.version > 0:
            self._resume()

    def _resume(self) -> None:
        """Params, optimizer state and generator state of the latest
        version (written by either package)."""
        try:
            state = self.checkpoint_manager.load_model_raw()
            convert.load_flax_variables(self.model,
                                        {"params": state["params"]})
            load_opt_state_from_flax(self.optimizer, self.model,
                                     state["opt_state"], self.config_optim)
            set_generator_state(self.generator, state["rng"])
        except (FileNotFoundError, KeyError, ValueError) as e:
            print(f"Could not resume from checkpoint ({e}); starting fresh")
            return
        self.start_epoch = self.checkpoint_manager.version
        print(f"Resumed from checkpoint v{self.start_epoch}")

    def train_step(self, g: LatticeGraph, labels: torch.Tensor,
                   weights: torch.Tensor):
        return lattice_train_step(self.model, self.optimizer, self.loss_fcn,
                                  g, labels, weights, self.generator)

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
        """What a checkpoint version holds, as flax-layout numpy trees."""
        return {
            "params": convert.params_to_flax(
                self.model, dict(self.model.named_parameters())),
            "batch_stats": {},
            "opt_state": opt_state_to_flax(self.optimizer, self.model,
                                           self.config_optim),
            "rng": generator_state(self.generator),
        }

    def evaluate_split(self, split_path: str) -> Dict[str, float]:
        if split_path not in self._eval_splits:
            data, average = select_dataset(self.config_data, split_path,
                                           "eval")
            self._eval_splits[split_path] = (
                average, lattice_eval_loader(data, self.config, self.device))
        average, loader = self._eval_splits[split_path]
        return evaluate_lattice(self.model, loader, average,
                                fwd=self._eval_fwd)
