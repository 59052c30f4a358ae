"""Train / evaluate / explain entry point of the port, mirroring the root
main.py:

  python -m wsi_hgnn_tpu_torch.main -config configs/BRCA/HEAT4_kimia_classification.yml -seed 611
  python -m wsi_hgnn_tpu_torch.main -config ... -mode eval
  python -m wsi_hgnn_tpu_torch.main -config ... -mode graph_explain
  python -m wsi_hgnn_tpu_torch.main -config ... -device cpu   # the CPU (tests)
  torchrun --nproc-per-node 8 -m wsi_hgnn_tpu_torch.main -config ...

Runs on the card unless `-device cpu` is given; without a card it raises.
Under torchrun (WORLD_SIZE > 1) only `-mode train` runs (eval and
graph_explain raise: every rank would write the same outputs): every
process joins one process group (NCCL on the cards, each process on
cuda:LOCAL_RANK; gloo with `-device cpu`), training shards batches whose
edge store exceeds `train.big_graph_edge_threshold` over the ranks
(train/trainer.py), and rank 0 writes the checkpoints.
"""
from __future__ import annotations

import argparse
import os
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

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return _run(args, args.device)
    if args.mode != "train":
        # every rank would run the whole job and write the same outputs
        raise ValueError(f"-mode {args.mode} runs in one process; launch it "
                         f"without torchrun (WORLD_SIZE is {world})")
    import torch.distributed as dist

    device = join_process_group(args.device)
    try:
        return _run(args, device)
    finally:
        dist.destroy_process_group()


def join_process_group(device):
    """Join torchrun's process group (its environment names the
    rendezvous): NCCL with this process on cuda:LOCAL_RANK, or gloo for
    `-device cpu`. Returns the device this process runs on."""
    import torch
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device == "cpu":
        dist.init_process_group("gloo")
        return device
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    return f"cuda:{local}"


def _run(args, device):
    opt_path = args.config or str(
        CONFIG_DIR / "BRCA/HEAT2_kimia_classification.yml")
    from .config import load_config

    config = load_config(opt_path)
    print(f"Loaded configs from {opt_path}")

    if args.mode == "train":
        if config["train_type"] != "gnn":
            raise NotImplementedError("This type of model is not implemented")
        from .train import GNNTrainer

        return GNNTrainer(config, seed=args.seed, device=device).train()
    if args.mode == "eval":
        if config["eval_type"] != "homo-graph":
            raise NotImplementedError(
                "This type of evaluator is not implemented")
        from .train import HomoGraphEvaluator

        return HomoGraphEvaluator(config, device=device).eval()
    from .explain import ExplainGraph

    return ExplainGraph(config, device=device).eval()


if __name__ == "__main__":
    main()
