"""ReMix dataset processing with the port (counterpart of
tools/process_remix_dataset.py; host work only): per-slide graphs into the
ReMix bag layout the k-fold mains read.

Each labelled graph `.npz` (its `feat`) or bag `.npy` under --graph-dir is
written as `<out>/<k>-<class>-npy/<slide>.npy` (class normal, tumor, or
class beyond the binary datasets), with a copy in
`<out>/bags/`; per class, the first int((len + 1) * 0.80) slides go to
train and the rest to test, each split then shuffled by Python's
`random` seeded with --seed, into `remix_processed/{train,test}_list.txt`
(path,label rows) and `{train,test}_bag_labels.npy`; `labels.csv` lists
every bag, so train_mil reads the result directly:

  python -m wsi_hgnn_tpu_torch.tools.process_remix_dataset \\
      --graph-dir out/homogeneous --labels labels.csv --out datasets/BRCA
  python -m wsi_hgnn_tpu_torch.train_mil --model dsmil \\
      --feats-dir datasets/BRCA/bags --labels datasets/BRCA/labels.csv
"""
from __future__ import annotations

import argparse
import glob
import os
import random
import shutil

import numpy as np

from ..train_mil import read_labels_csv


def class_tokens(labels_map):
    """label id -> directory token ('0-normal', '1-tumor', '{k}-class'
    beyond the binary datasets)."""
    ids = sorted(set(labels_map.values()))
    names = {0: "normal", 1: "tumor"}
    return {k: f"{k}-{names.get(k, 'class')}" for k in ids}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph-dir", required=True,
                    help="per-slide graph .npz dir (construct output) or "
                         "bag .npy dir")
    ap.add_argument("--labels", required=True, help="CSV name,label")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    labels_map = read_labels_csv(args.labels)
    tokens = class_tokens(labels_map)
    random.seed(args.seed)

    os.makedirs(os.path.join(args.out, "bags"), exist_ok=True)
    per_class = {k: [] for k in tokens}
    for path in sorted(glob.glob(os.path.join(args.graph_dir, "*.np[yz]"))):
        name = os.path.basename(path).rsplit(".", 1)[0]
        if name not in labels_map:
            continue
        if path.endswith(".npz"):
            with np.load(path) as z:
                feats = np.asarray(z["feat"], np.float32)
        else:
            feats = np.asarray(np.load(path), np.float32)
        label = labels_map[name]
        d = os.path.join(args.out, tokens[label] + "-npy")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, name + ".npy"), feats)
        shutil.copy(os.path.join(d, name + ".npy"),
                    os.path.join(args.out, "bags", name + ".npy"))
        per_class[label].append(name)

    n_bags = sum(len(v) for v in per_class.values())
    if not n_bags:
        raise SystemExit(f"no labelled graphs under {args.graph_dir}")

    train, test = [], []
    for k in sorted(per_class):
        wsis = per_class[k]
        cut = int((len(wsis) + 1) * 0.80)
        train += [(w, k) for w in wsis[:cut]]
        test += [(w, k) for w in wsis[cut:]]
    random.shuffle(train)
    random.shuffle(test)

    proc = os.path.join(args.out, "remix_processed")
    os.makedirs(proc, exist_ok=True)
    for split, rows in (("train", train), ("test", test)):
        with open(os.path.join(proc, f"{split}_list.txt"), "w") as f:
            for name, k in rows:
                f.write(os.path.join(args.out, tokens[k] + "-npy",
                                     name + ".npy") + f",{k}\n")
        np.save(os.path.join(proc, f"{split}_bag_labels.npy"),
                np.asarray([k for _, k in rows]))
    with open(os.path.join(args.out, "labels.csv"), "w") as f:
        for k in sorted(per_class):
            for name in per_class[k]:
                f.write(f"{name},{k}\n")
    print(f"{n_bags} bags -> {args.out} ({len(train)} train / "
          f"{len(test)} test)")
    return args.out


if __name__ == "__main__":
    main()
