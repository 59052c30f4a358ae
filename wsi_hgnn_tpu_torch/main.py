"""Train / evaluate / explain entry point of the port, mirroring the root
main.py:

  python -m wsi_hgnn_tpu_torch.main -config configs/BRCA/HEAT4_kimia_classification.yml -seed 611
  python -m wsi_hgnn_tpu_torch.main -config ... -mode eval
  python -m wsi_hgnn_tpu_torch.main -config ... -mode graph_explain
  python -m wsi_hgnn_tpu_torch.main -config ... -device cpu   # the CPU (tests)

Runs on the card unless `-device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-config", type=str, default="",
                        help="Path to option YAML file.")
    parser.add_argument("-seed", type=int, default=611,
                        help="random seed of the run")
    parser.add_argument("-mode", type=str, default="train",
                        choices=["train", "eval", "graph_explain"])
    parser.add_argument("-device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    opt_path = args.config or str(
        CONFIG_DIR / "BRCA/HEAT2_kimia_classification.yml")
    from .config import load_config

    config = load_config(opt_path)
    print(f"Loaded configs from {opt_path}")

    if args.mode == "train":
        if config["train_type"] != "gnn":
            raise NotImplementedError("This type of model is not implemented")
        from .train import GNNTrainer

        return GNNTrainer(config, seed=args.seed, device=args.device).train()
    if args.mode == "eval":
        if config["eval_type"] != "homo-graph":
            raise NotImplementedError(
                "This type of evaluator is not implemented")
        from .train import HomoGraphEvaluator

        return HomoGraphEvaluator(config, device=args.device).eval()
    from .explain import ExplainGraph

    return ExplainGraph(config, device=args.device).eval()


if __name__ == "__main__":
    main()
