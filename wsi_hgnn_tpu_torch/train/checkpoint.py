"""Versioned checkpoints in the JAX package's on-disk contract
(counterpart of wsi_hgnn_tpu/train/checkpoint.py):

  <path>/version.txt            fsync'd current version number
  <path>/configs.json           config snapshot, written with version 1
  <path>/model_v{N}.msgpack     flax msgpack: params, batch_stats,
                                opt_state, rng
  <path>/training_stats.json    append-only JSON lines of epoch stats

What the port writes under `params` is the flax tree name for name
(`convert.params_to_flax`), `batch_stats` the models' running statistics
in flax's collection ({} for models without any), and `opt_state` has
the layout of the optax chain that wsi_hgnn_tpu/config.py::parse_optimizer
builds for the same config, so each package resumes the other's run.
`rng` is a JAX PRNG key (uint32 [2]) holding a 64-bit seed that the
trainer's torch.Generator was reseeded with when the version was
written, so a resumed port run continues exactly as an uninterrupted one
and the JAX trainer resumes with it as its key.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import convert
from . import flax_msgpack


class CheckpointManager:
    def __init__(self, path: str) -> None:
        self.path = Path(path)
        self.version = self.load_version()
        self.old_version = 0
        self.path.mkdir(parents=True, exist_ok=True)

    # -- file layout -------------------------------------------------- #
    def get_version_file(self) -> Path:
        return self.path / "version.txt"

    def get_config_file(self) -> Path:
        return self.path / "configs.json"

    def get_model_file(self, version: int) -> Path:
        return self.path / f"model_v{version}.msgpack"

    def get_stats_file(self) -> Path:
        return self.path / "training_stats.json"

    # -- config / stats ------------------------------------------------ #
    def save_config(self, config: Dict) -> None:
        self.get_config_file().write_text(json.dumps(config, indent=4))

    def load_config(self) -> str:
        return self.get_config_file().read_text()

    def append_stats(self, stats: Dict) -> None:
        with self.get_stats_file().open("at") as tf:
            tf.write(json.dumps(stats) + "\n")

    def load_stats(self):
        """The stats file's lines (one JSON object each), lazily."""
        with self.get_stats_file().open("rt") as tf:
            yield from tf

    # -- model state ---------------------------------------------------- #
    def save_model(self, state: Dict) -> None:
        """`state`: nested dicts of numpy leaves, written as flax msgpack."""
        self.get_model_file(self.version).write_bytes(
            flax_msgpack.to_bytes(state))

    def load_model_raw(self) -> Dict:
        """The latest version as nested dicts of numpy arrays."""
        return flax_msgpack.restore(
            self.get_model_file(self.version).read_bytes())

    def restore_variables(self) -> Dict:
        """Latest checkpoint -> {'params', ['batch_stats']} as numpy trees.
        A missing checkpoint raises: random weights would print plausible
        chance-level metrics."""
        try:
            restored = self.load_model_raw()
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no checkpoint under {str(self.path)!r} (version "
                f"{self.version}); train first or fix checkpoint.path"
            ) from None
        variables = {"params": restored["params"]}
        if restored.get("batch_stats"):
            variables["batch_stats"] = restored["batch_stats"]
        return variables

    # -- versioning ------------------------------------------------------ #
    def save_version(self, version: int) -> None:
        with self.get_version_file().open("wt") as tf:
            tf.write(f"{version}\n")
            tf.flush()
            os.fsync(tf.fileno())

    def load_version(self) -> int:
        try:
            s = self.get_version_file().read_text().strip()
        except FileNotFoundError:
            return 0
        return int(s) if s else 0

    def write_new_version(self, config: Dict, state: Dict,
                          epoch_stats: Dict) -> None:
        """Write version epoch_stats['Epoch']; the stats' floats are rounded
        to 5 digits in place, as the JAX package does."""
        if self.version == 0:
            self.save_config(config)
        self.old_version = self.version
        self.version = epoch_stats["Epoch"]
        self.save_version(self.version)
        self.save_model(state)
        for k, v in epoch_stats.items():
            if not isinstance(v, int):
                epoch_stats[k] = round(float(v), 5)
        self.append_stats(epoch_stats)

    def remove_old_version(self) -> None:
        try:
            self.get_model_file(self.old_version).unlink()
        except FileNotFoundError:
            pass


# --------------------------------------------------------------------- #
# optimizer state <-> the optax chain's state dict
# --------------------------------------------------------------------- #
# per optimizer: (torch state key, optax field) of each moment tree
_MOMENTS = {"adam": (("exp_avg", "mu"), ("exp_avg_sq", "nu")),
            "adadelta": (("square_avg", "e_g"), ("acc_delta", "e_x")),
            "adagrad": (("sum", None),)}


def _method(config_optim: Dict) -> str:
    m = str(config_optim["opt_method"]).lower()
    return m if m in ("adam", "adagrad", "adadelta") else "sgd"


def opt_state_to_flax(optimizer: torch.optim.Optimizer, model: nn.Module,
                      config_optim: Dict) -> Dict:
    """torch optimizer state -> the state dict of the optax chain the JAX
    package builds for `config_optim`: [{} for the L2 term when
    weight_decay != 0] + [the scaling state] + [{} or Adagrad's schedule
    count], keyed "0", "1", ...; moments in flax layout, counts int32."""
    method = _method(config_optim)
    named = dict(model.named_parameters())
    states = [optimizer.state.get(p, {}) for p in named.values()]
    step = next((int(s["step"]) for s in states if "step" in s), 0)
    count = np.asarray(step, np.int32)

    def tree(key):
        return convert.params_to_flax(model, {
            n: optimizer.state.get(p, {}).get(key, torch.zeros_like(p))
            for n, p in named.items()})

    parts = [{}] if float(config_optim.get("weight_decay", 0.0)) else []
    if method == "adagrad":
        parts += [tree("sum"), {"count": count}]
    elif method == "adam":
        parts += [{"count": count, "mu": tree("exp_avg"),
                   "nu": tree("exp_avg_sq")}, {}]
    elif method == "adadelta":
        parts += [{"e_g": tree("square_avg"), "e_x": tree("acc_delta")}, {}]
    else:
        parts += [{}, {}]
    return {str(i): part for i, part in enumerate(parts)}


def load_opt_state_from_flax(optimizer: torch.optim.Optimizer,
                             model: nn.Module, tree: Dict,
                             config_optim: Dict) -> None:
    """The inverse of opt_state_to_flax, into `optimizer` in place. A tree
    of another layout raises KeyError or ValueError."""
    method = _method(config_optim)
    parts = [tree[str(i)] for i in range(len(tree))]
    if float(config_optim.get("weight_decay", 0.0)):
        parts = parts[1:]
    if len(parts) != 2:
        raise ValueError(f"opt_state has {len(tree)} chain entries, not the "
                         f"layout of {config_optim['opt_method']!r}")
    if method == "sgd":
        return
    inner = parts[0]
    count = {"adam": lambda: inner["count"],
             "adagrad": lambda: parts[1]["count"],
             "adadelta": lambda: 0}[method]()
    moments = {key: convert.params_from_flax(model, inner if field is None
                                             else inner[field])
               for key, field in _MOMENTS[method]}
    for name, p in model.named_parameters():
        st = {"step": torch.tensor(float(count))}
        for key, arrays in moments.items():
            st[key] = torch.from_numpy(arrays[name]).to(p.device, p.dtype)
        optimizer.state[p] = st


def generator_key(generator: torch.Generator) -> np.ndarray:
    """A checkpoint's `rng`: a 64-bit seed drawn from `generator`, which is
    then reseeded with it, as uint32 [low, high] (a JAX PRNG key)."""
    seed = int(torch.randint(2 ** 63 - 1, (1,), generator=generator,
                             device=generator.device).item())
    generator.manual_seed(seed)
    return np.array([seed & 0xFFFFFFFF, seed >> 32], np.uint32)


def set_generator_state(generator: torch.Generator, rng: np.ndarray) -> None:
    """Reseed a generator from a checkpoint's `rng` (the port's key or a
    JAX-written one): its first 8 bytes, little-endian."""
    arr = np.asarray(rng)
    generator.manual_seed(int.from_bytes(arr.tobytes()[:8], "little"))
