"""Training, evaluation and checkpoints on the lattice and TypedGraph
paths."""
from .checkpoint import CheckpointManager
from .evaluator import HomoGraphEvaluator, evaluate
from .metrics import accuracy, metrics
from .trainer import (GNNTrainer, lattice_train_step, select_dataset,
                      typed_train_step)

__all__ = ["CheckpointManager", "GNNTrainer", "HomoGraphEvaluator",
           "accuracy", "evaluate", "lattice_train_step",
           "metrics", "select_dataset", "typed_train_step"]
