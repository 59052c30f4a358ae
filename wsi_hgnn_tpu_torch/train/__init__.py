"""Training, evaluation and checkpoints on the lattice path."""
from .checkpoint import CheckpointManager
from .evaluator import HomoGraphEvaluator, evaluate_lattice
from .metrics import accuracy, metrics
from .trainer import GNNTrainer, lattice_train_step, select_dataset

__all__ = ["CheckpointManager", "GNNTrainer", "HomoGraphEvaluator",
           "accuracy", "evaluate_lattice", "lattice_train_step", "metrics",
           "select_dataset"]
