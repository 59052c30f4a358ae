"""Slide -> graph construction and split generation entry point of the
port, mirroring the root get_graph.py (the reference's get_graph.py with
--construct / --trainval flags in place of its module globals, and --yes
in place of its confirmation prompt):

  python -m wsi_hgnn_tpu_torch.get_graph -config configs/GraphConstruction/BRCA_HovernetKimia_graph_constructor.yml --construct
  python -m wsi_hgnn_tpu_torch.get_graph -config ... --trainval --fold 1 --yes --normal-path <list>
  python -m wsi_hgnn_tpu_torch.get_graph -config ... --construct -device cpu   # no card

Construction runs on the card unless `-device cpu` is given; without a
card it raises. Split generation is host work.
"""
from __future__ import annotations

import argparse
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-config", type=str, default="",
                        help="Path to option YAML file.")
    parser.add_argument("--construct", action="store_true",
                        help="construct graphs from patch dirs")
    parser.add_argument("--trainval", action="store_true",
                        help="write train/val/test split lists")
    parser.add_argument("--fold", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--normal-path", type=str, default="",
                        help="normal-slide barcode list "
                             "(classification/staging)")
    parser.add_argument("--label-path", type=str, default="",
                        help="staging/typing label table")
    parser.add_argument("--yes", action="store_true",
                        help="skip the interactive confirmation prompt")
    parser.add_argument("-device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    opt_path = args.config or str(
        CONFIG_DIR / "GraphConstruction/BRCA_HovernetKimia_graph_constructor.yml")
    from .config import load_config

    config = load_config(opt_path)
    print(f"Loaded configs from {opt_path}")
    graph_config = config["graph_constructor"]
    hovernet_config = config.get("hovernet_config") or {}
    kimianet_config = config.get("kimianet_config") or {}

    if args.construct:
        from .pipeline import construct_all

        n = construct_all(graph_config, hovernet_config, kimianet_config,
                          device=args.device)
        print(f"Constructed {n} slide graphs")

    if args.trainval:
        from .pipeline import generate_splits

        if not args.yes:
            if input("Proceed? y/n\n") == "n":
                return
        out = generate_splits(graph_config, fold=args.fold, seed=args.seed,
                              normal_path=args.normal_path,
                              label_path=args.label_path)
        print(f"Lists saved in {out}")


if __name__ == "__main__":
    main()
