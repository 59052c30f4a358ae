"""MIL baseline training with the port (counterpart of the root
train_mil.py): the reference's k-fold mains behind one CLI.

  * abmil / dsmil, optionally with ReMix reduction and latent
    augmentation: Adam(betas 0.5, 0.9) with coupled L2 `--weight-decay`,
    the cosine LR of the epoch down to 5e-6, BCE-with-logits (DSMIL: the
    mean of the bag's and the max instance's), test score sigmoid(bag);
  * gtn: the GTNMIL GraphTransformer over the 8-neighbour tile graph
    (dense [cap, cap] adjacency built per call on the device, cap =
    bucket_size(largest bag, 64)), CE plus the mincut losses, Adam
    weight decay 5e-4, the same cosine LR, test score softmax(logits);
  * h2mil: the multi-resolution tree through RAConv/IHPool, the
    reference's CE of the softmax, Adam with coupled L2 5e-4 at a
    constant LR, dropout live in training (drawn from a torch.Generator
    seeded with --seed + 1). The parent level is synthesised from the
    single-magnification bags (`--cell`), or, with `--nested-bags`, both
    levels are real: the tiler's two-magnification nested bags featurized
    by `--encoder` (random, kimia, efficientnet-b4), the `-1.jpeg`
    thumbnail too where present;
  * gigapath: Prov-GigaPath's LongNet slide encoder with a linear head
    (models/mil/longnet.py) over each bag's tiles at their coordinates
    (the bags' `xy` grid cells, times the 256-px tile size: the model
    takes pixels), one slide a step: AdamW (betas 0.9, 0.999, --weight-decay
    0.05 by default) at a base --lr of 2e-3 by default with layer-wise
    rate decay 0.95 from the head down (GigaPath's fine-tuning settings as
    read here), the same cosine LR, CE; bf16 autocast on the card (f32
    weights, AdamW state, LayerNorms and softmax statistics), f32 on the
    CPU; weights from torch's initialisers at --seed
    (`LongNetViT.load_slide_encoder` takes the published
    slide_encoder.pth); `--save-dir` writes each fold's torch state dict,
    no JAX pickle. Each step is the `train/step` span.

  python -m wsi_hgnn_tpu_torch.train_mil --model dsmil --feats-dir bags/ \\
      --labels labels.csv --folds 5 --epochs 50 [--remix-mode cov]
  python -m wsi_hgnn_tpu_torch.train_mil --model gtn ... [--device cpu]
  python -m wsi_hgnn_tpu_torch.train_mil --model h2mil --nested-bags \\
      --encoder kimia --feats-dir tiled/ --labels labels.csv
  python -m wsi_hgnn_tpu_torch.train_mil --model gigapath --feats-dir bags/ \\
      --labels labels.csv

Bags are `.npy` [N, D] files or graph `.npz` files (their `feat`; an `xy`
[N, 2] of tile grid cells (col, row), as the tiler names its tiles
`{col}_{row}.jpeg` and pretrain_simclr's extraction writes them, feeds
gtn, h2mil and gigapath, else a square raster grid; gigapath needs it).
Labels come from a `name,label` CSV. The folds, the epoch order and the
ReMix draws come from np.random.RandomState(--seed) as in JAX; the
weights are drawn by convert.init_flax_like_(--seed) with flax's
initialisers. Each fold's weights can be written as the JAX pickle
(`--save-dir`). Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import convert, profiling
from .graph.typed_graph import bucket_size
from .models.mil import (ABMIL, DSMIL, H2MIL, GraphTransformer, LongNetViT,
                         mix_the_bag_aug, pad_bag, reduce_bag,
                         spatial_adjacency)
from .models.mil.h2mil import (build_tree_graph, build_tree_graph_levels,
                               fill_dead_grads, scan_nested_bag,
                               tree_to_torch)
from .models.mil.longnet import param_groups
from .train.metrics import accuracy, metrics
from .utils import resolve_device, set_cuda_numerics

ETA_MIN = 5e-6
# --lr and --weight-decay when not given: gigapath's AdamW, else Adam's
HYPER = {"gigapath": {"lr": 2e-3, "weight_decay": 0.05}}
HYPER_DEFAULT = {"lr": 2e-4, "weight_decay": 5e-3}
GIGAPATH_LAYER_DECAY = 0.95


def read_labels_csv(labels_csv: str) -> Dict[str, int]:
    labels_map = {}
    with open(labels_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.lower().startswith("name"):
                continue
            name, label = line.split(",")[:2]
            labels_map[name] = int(label)
    return labels_map


def load_bags(feats_dir: str, labels_csv: str):
    """(bags, labels, names, coords): coords[i] is [N, 2] int or None."""
    labels_map = read_labels_csv(labels_csv)
    bags, labels, names, coords = [], [], [], []
    for p in sorted(glob.glob(os.path.join(feats_dir, "*.np[yz]"))):
        name = os.path.basename(p).rsplit(".", 1)[0]
        if name not in labels_map:
            continue
        xy = None
        if p.endswith(".npz"):
            with np.load(p) as z:
                feats = z["feat"]
                if "xy" in z:
                    xy = np.asarray(z["xy"], np.int64)
        else:
            feats = np.load(p)
        bags.append(np.asarray(feats, np.float32))
        labels.append(labels_map[name])
        names.append(name)
        coords.append(xy)
    return bags, np.asarray(labels, np.int64), names, coords


def grid_coords(n: int) -> np.ndarray:
    """Square raster-grid fallback when tile coordinates are unknown."""
    w = int(np.ceil(np.sqrt(n)))
    i = np.arange(n)
    return np.stack([i % w, i // w], 1).astype(np.int64)


def stratified_kfold_split(labels, folds: int):
    """The reference mains' k-fold protocol: per-class contiguous
    np.array_split folds, the held-out fold halved per class into val
    (first half) and test (second half), train = every other fold.
    Returns [(train_idx, val_idx, test_idx)] per fold."""
    labels = np.asarray(labels)
    per_class = [np.flatnonzero(labels == c) for c in np.unique(labels)]
    out = []
    for fi in range(folds):
        tr, va, te = [], [], []
        for idx in per_class:
            for j, part in enumerate(np.array_split(idx, folds)):
                if j != fi:
                    tr.append(part)
                else:
                    halves = np.array_split(part, 2)
                    va.append(halves[0])
                    te.append(halves[1])
        out.append(tuple(np.concatenate(x).astype(np.int64)
                         for x in (tr, va, te)))
    return out


def summarize(model_name: str, fold_metrics: List[Tuple[float, float, float]]):
    fm = np.asarray(fold_metrics, float)
    out = {
        "model": model_name,
        "acc_mean": float(np.nanmean(fm[:, 0])),
        "acc_std": float(np.nanstd(fm[:, 0])),
        "f1_mean": float(np.nanmean(fm[:, 1])),
        "f1_std": float(np.nanstd(fm[:, 1])),
        "auc_mean": float(np.nanmean(fm[:, 2])),
        "auc_std": float(np.nanstd(fm[:, 2])),
    }
    print(json.dumps(out))
    return out


def mil_reference_loss(model_name: str, bag_logits: torch.Tensor,
                       max_logits: torch.Tensor,
                       onehot: torch.Tensor) -> torch.Tensor:
    """dsmil: 0.5 BCE(bag) + 0.5 BCE(max instance), a mixture of LOSSES;
    abmil: BCE(bag). BCE is nn.BCEWithLogitsLoss on a one-hot target."""
    bag = F.binary_cross_entropy_with_logits(bag_logits, onehot)
    if model_name == "abmil":
        return bag
    return 0.5 * bag + 0.5 * F.binary_cross_entropy_with_logits(max_logits,
                                                                onehot)


def cosine_epoch_schedule(lr: float, epochs: int,
                          eta_min: float = ETA_MIN) -> Callable[[int], float]:
    """lr(epoch) of torch's CosineAnnealingLR(num_epochs, eta_min) stepped
    once per epoch, the closed form optax's cosine_decay_schedule gives
    at count // steps_per_epoch."""
    t_max = max(epochs, 1)
    return lambda e: eta_min + (lr - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * min(e, t_max) / t_max))


def save_fold_params(save_dir, model_name, fold, variables: Dict, meta):
    """A fold's flax-named weights and rebuild metadata as the JAX pickle
    ({"params": variables, "meta": meta}), so the JAX tools read it."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{model_name}_fold{fold}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": variables, "meta": meta}, f)
    return path


def _init(model: torch.nn.Module, seed: int,
          init_variables: Optional[Dict]) -> torch.nn.Module:
    if init_variables is None:
        return convert.init_flax_like_(model, seed)
    return convert.load_flax_variables(model, init_variables)


def hyper(args, key: str) -> float:
    """--lr or --weight-decay as given, else the model's default."""
    value = getattr(args, key)
    if value is not None:
        return value
    return HYPER.get(args.model, HYPER_DEFAULT)[key]


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """`lr` on every group, times the group's `lr_scale` where it has one."""
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


def run_epochs(args, rng, n_train: int, opt, step,
               lr_of: Optional[Callable[[int], float]] = None) -> None:
    """--epochs epochs over a fold's n_train training bags, each in the
    order of rng.permutation; step(j) steps the j-th; lr_of(epoch), when
    given, sets the epoch's rate."""
    for epoch in range(args.epochs):
        if lr_of is not None:
            _set_lr(opt, lr_of(epoch))
        for j in rng.permutation(n_train):
            step(j)


def run_folds(args, labels, name: str, fit, probs, save) -> Dict:
    """The k folds every model runs: the stratified split, a fold with an
    empty test split skipped, fit(train_idx) -> a trained model,
    probs(model, i) -> bag i's class probabilities, the fold's metrics,
    save(model, fold) under --save-dir; the summary."""
    fold_metrics = []
    for fi, (train_idx, val_idx, test_idx) in enumerate(
            stratified_kfold_split(labels, args.folds)):
        print(f"fold {fi}: {len(train_idx)} train / {len(val_idx)} val / "
              f"{len(test_idx)} test")
        if len(test_idx) == 0:
            print(f"fold {fi}: empty test split, skipping")
            fold_metrics.append((float("nan"),) * 3)
            continue
        model = fit(train_idx)
        model.eval()
        with torch.no_grad():
            p = np.stack([probs(model, i) for i in test_idx])
        acc, f1, aucv = _fold_metrics(p, labels[test_idx], args.num_classes)
        fold_metrics.append((acc, f1, aucv))
        print(f"fold {fi}: acc {acc:.4f} f1 {f1:.4f} auc {aucv:.4f}")
        if args.save_dir:
            save(model, fi)
    return summarize(name, fold_metrics)


def _fold_metrics(probs, ys, num_classes):
    acc = accuracy(probs, ys)
    _, _, f1, aucv = metrics(probs, ys,
                             "binary" if num_classes == 2 else "macro")
    return acc, f1, aucv


# ------------------------------------------------------------------------- #
def bag_logits(model, model_name: str, feats, mask):
    """(bag logits [1, C], masked max-instance logits [1, C])."""
    if model_name == "abmil":
        bag = model(feats, mask)
        return bag, bag
    classes, bag, _, _ = model(feats, mask)
    return bag, torch.where(mask[:, None], classes, -1e30).max(
        0, keepdim=True).values


def bag_train_step(model, opt, model_name: str, num_classes: int, feats,
                   mask, label: int) -> torch.Tensor:
    """One step of the reference loss; the model runs as in evaluation
    (DSMIL's train=False inside the loss)."""
    model.eval()
    opt.zero_grad()
    bag, mx = bag_logits(model, model_name, feats, mask)
    onehot = F.one_hot(torch.tensor([label], device=feats.device),
                       num_classes).to(feats.dtype)
    loss = mil_reference_loss(model_name, bag, mx, onehot)
    loss.backward()
    opt.step()
    return loss.detach()


def run_bag_models(args, bags, labels, init_variables: Optional[Dict] = None):
    """abmil / dsmil k-fold; `init_variables` (a flax tree) replaces the
    seeded init of every fold."""
    dev = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    d = int(bags[0].shape[1])
    cls = ABMIL if args.model == "abmil" else DSMIL
    # capacity covers the untouched test bags and the augmented training
    # bags (reduced to num_prototypes rows; up to one appended row per
    # instance per append op, three ops per instance in 'joint' mode)
    max_bag = max(len(b) for b in bags)
    if args.remix_mode:
        grow = 4 if args.remix_mode == "joint" else 2
        cap = max(max_bag, grow * args.num_prototypes, 8)
    else:
        cap = max(max_bag, 8)

    def on_dev(feats):
        f, m = pad_bag(feats, capacity=cap)
        return torch.from_numpy(f).to(dev), torch.from_numpy(m).to(dev)

    lr = hyper(args, "lr")

    def fit(train_idx):
        shifts = None
        if args.remix_mode:
            reduced = [reduce_bag(bags[i], args.num_prototypes, device=dev)
                       for i in train_idx]
            train_bags = [r[0] for r in reduced]
            shifts = [r[1] for r in reduced]
        else:
            train_bags = [bags[i] for i in train_idx]
        model = _init(cls(args.num_classes, d), args.seed,
                      init_variables).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.5, 0.9),
                               eps=1e-8,
                               weight_decay=hyper(args, "weight_decay"))

        def step(j):
            feats = train_bags[j]
            if args.remix_mode:
                feats = mix_the_bag_aug(
                    feats, j, train_bags, labels[train_idx],
                    args.remix_mode, args.remix_rate,
                    semantic_shifts=shifts, rng=rng)
            bag_train_step(model, opt, args.model, args.num_classes,
                           *on_dev(feats), int(labels[train_idx[j]]))

        run_epochs(args, rng, len(train_idx), opt, step,
                   cosine_epoch_schedule(lr, args.epochs))
        return model

    def probs(model, i):
        return torch.sigmoid(bag_logits(
            model, args.model, *on_dev(bags[i]))[0])[0].cpu().numpy()

    def save(model, fi):
        save_fold_params(args.save_dir, args.model, fi,
                         convert.to_flax_variables(model),
                         dict(model=args.model, num_classes=args.num_classes,
                              in_dim=d, cap=int(cap)))

    return run_folds(args, labels, args.model, fit, probs, save)


# ------------------------------------------------------------------------- #
def dense_adjacency(edges, cap: int, dev: torch.device) -> torch.Tensor:
    """[1, cap, cap] 0/1 adjacency of an (src, dst) edge list, on `dev`."""
    src, dst = (torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                for a in edges)
    adj = torch.zeros(cap, cap, device=dev)
    adj[src, dst] = 1.0
    return adj[None]


def gtn_train_step(model, opt, feats, adj, mask, label: int) -> torch.Tensor:
    """CE of the logits plus the mincut losses; the GCN block's BatchNorm
    uses and updates the batch statistics."""
    model.train()
    opt.zero_grad()
    logits, aux = model(feats, adj, mask)
    loss = -F.log_softmax(logits, -1)[0, label] + aux
    loss.backward()
    opt.step()
    return loss.detach()


def run_gtn(args, bags, labels, coords, init_variables: Optional[Dict] = None):
    dev = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    d = int(bags[0].shape[1])
    cap = bucket_size(max(len(b) for b in bags), base=64)
    # the 8-neighbour edge list of each slide, built once
    edge_lists = [
        spatial_adjacency([tuple(c) for c in (
            xy if xy is not None else grid_coords(len(b)))])
        for b, xy in zip(bags, coords)]

    def make_inputs(i):
        f, m = pad_bag(bags[i], capacity=cap)
        return (torch.from_numpy(f[None]).to(dev),
                dense_adjacency(edge_lists[i], cap, dev),
                torch.from_numpy(m[None]).to(dev))

    lr = hyper(args, "lr")

    def fit(train_idx):
        model = _init(GraphTransformer(
            n_class=args.num_classes, in_dim=d, embed_dim=args.hidden,
            node_cluster_num=args.clusters), args.seed, init_variables).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8,
                               weight_decay=5e-4)

        def step(j):
            i = train_idx[j]
            gtn_train_step(model, opt, *make_inputs(i), int(labels[i]))

        run_epochs(args, rng, len(train_idx), opt, step,
                   cosine_epoch_schedule(lr, args.epochs))
        return model

    def probs(model, i):
        return torch.softmax(model(*make_inputs(i))[0], -1)[0].cpu().numpy()

    def save(model, fi):
        save_fold_params(args.save_dir, "gtn", fi,
                         convert.to_flax_variables(model),
                         dict(model="gtn", num_classes=args.num_classes,
                              hidden=args.hidden, clusters=args.clusters,
                              in_dim=d, cap=int(cap)))

    return run_folds(args, labels, "gtn", fit, probs, save)


# ------------------------------------------------------------------------- #
def nested_slide_dirs(nested_dir: str, labels_map: Dict[str, int],
                      ext: str = "jpeg"):
    """[(name, dir)] of the labelled slide bags under `nested_dir`, found
    directly under it or one class level down (the tiler's layout); a
    slide's own child-tile directories are never entered."""
    slide_dirs = []
    for root, dirs, files in os.walk(nested_dir):
        if any(f.endswith("." + ext) for f in files):
            name = os.path.basename(root)
            if name in labels_map:
                slide_dirs.append((name, root))
        if os.path.basename(root) in labels_map:
            dirs.clear()
    return sorted(slide_dirs)


def load_nested_trees(nested_dir: str, labels_csv: str, encoder_name: str,
                      ext: str = "jpeg", batch_size: int = 32, device=None,
                      encoder=None):
    """Real two-magnification H2MIL input: scan each slide's nested bag,
    featurize both levels (and the thumbnail, when present) with one
    encoder (`encoder_name` through pipeline.construct.make_encoder, every
    chunk padded to `batch_size`; or `encoder`, a callable patches ->
    (features, types)), and build the TreeGraphs at one capacity
    (bucket_size of the largest, base 64). Returns (trees, labels, names)."""
    from .pipeline.construct import make_encoder
    from .pipeline.patches import iter_patch_batches

    labels_map = read_labels_csv(labels_csv)
    slide_dirs = nested_slide_dirs(nested_dir, labels_map, ext)
    if not slide_dirs:
        raise SystemExit(f"no labelled nested bags under {nested_dir}")
    if encoder is None:
        encoder = make_encoder(encoder_name, {"feature_dim": 1024}, {}, {},
                               with_typing=False, pad_batch_to=batch_size,
                               device=device)

    def featurize(paths):
        if not paths:
            return np.zeros((0, 1024), np.float32)
        return np.concatenate([encoder(pb)[0] for pb in
                               iter_patch_batches(paths, batch_size)])

    parts, labels, names = [], [], []
    for name, d in slide_dirs:
        low_paths, xy1, high_paths, xy2, parent, thumb = scan_nested_bag(d,
                                                                         ext)
        f1 = featurize(low_paths)
        f2 = featurize(high_paths)
        tf = featurize([thumb])[0] if thumb is not None else None
        parts.append((f1, xy1, f2, xy2, parent, tf))
        labels.append(labels_map[name])
        names.append(name)

    built = [build_tree_graph_levels(*p) for p in parts]
    cap_n = bucket_size(max(int(t.node_mask.sum()) for t in built), base=64)
    cap_e = bucket_size(max(int(t.edge_mask.sum()) for t in built), base=64)
    trees = [build_tree_graph_levels(*p, node_capacity=cap_n,
                                     edge_capacity=cap_e) for p in parts]
    return trees, np.asarray(labels, np.int64), names


def synthetic_trees(bags, coords, cell: int):
    """Single-magnification bags as H2MIL trees with a synthesised parent
    level, all at one capacity (bucket_size of the largest, base 64)."""
    xys = [xy if xy is not None else grid_coords(len(b))
           for b, xy in zip(bags, coords)]
    built = [build_tree_graph(b, xy, cell=cell) for b, xy in zip(bags, xys)]
    cap_n = bucket_size(max(int(t.node_mask.sum()) for t in built), base=64)
    cap_e = bucket_size(max(int(t.edge_mask.sum()) for t in built), base=64)
    return [build_tree_graph(b, xy, cell=cell, node_capacity=cap_n,
                             edge_capacity=cap_e)
            for b, xy in zip(bags, xys)]


def h2mil_loss(logits: torch.Tensor, label: int) -> torch.Tensor:
    """The reference's criterion: its GCN returns softmax(x) into
    nn.CrossEntropyLoss, so the loss is the CE of a softmax."""
    return -F.log_softmax(torch.softmax(logits, -1), -1)[0, label]


def h2mil_train_step(model, opt, tree, label: int,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """One H2MIL step in training mode (dropout masks from `generator`);
    IHPool's gradient-free weights get zero gradients, so the coupled L2
    moves them as in JAX."""
    model.train()
    opt.zero_grad()
    loss = h2mil_loss(model(tree, generator=generator), label)
    loss.backward()
    fill_dead_grads(model)
    opt.step()
    return loss.detach()


def run_h2mil(args, bags, labels, coords,
              init_variables: Optional[Dict] = None):
    """H2MIL k-fold. With --nested-bags the trees come from the nested
    image bags under --feats-dir (load_nested_trees), else from `bags`
    (synthetic_trees); `init_variables` (a flax tree) replaces the seeded
    init of every fold."""
    dev = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    if args.nested_bags:
        trees, labels, _ = load_nested_trees(args.feats_dir, args.labels,
                                             args.encoder, device=dev)
        print(f"{len(trees)} nested bags, classes: {np.bincount(labels)}")
    else:
        trees = synthetic_trees(bags, coords, args.cell)
    in_dim = int(trees[0].feats.shape[1])
    on_dev = [tree_to_torch(t, dev) for t in trees]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def fit(train_idx):
        model = _init(H2MIL(in_dim, args.hidden, args.num_classes,
                            k1=args.k1, k2=args.k2, dropout=args.dropout),
                      args.seed, init_variables).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=hyper(args, "lr"),
                               eps=1e-8, weight_decay=5e-4)

        def step(j):
            i = train_idx[j]
            h2mil_train_step(model, opt, on_dev[i], int(labels[i]), gen)

        run_epochs(args, rng, len(train_idx), opt, step)
        return model

    def probs(model, i):
        return torch.softmax(model(on_dev[i]), -1)[0].cpu().numpy()

    def save(model, fi):
        save_fold_params(args.save_dir, "h2mil", fi,
                         convert.to_flax_variables(model),
                         dict(model="h2mil", num_classes=args.num_classes,
                              hidden=args.hidden, k1=args.k1, k2=args.k2,
                              in_dim=in_dim))

    return run_folds(args, labels, "h2mil", fit, probs, save)


# ------------------------------------------------------------------------- #
def make_gigapath(in_dim: int, num_classes: int, device, seed: int = 0,
                  **arch) -> LongNetViT:
    """LongNetViT (`arch`: its sizes, the published ones by default) with
    torch's initialisers at `seed` and a N(0, 0.02^2) CLS token."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LongNetViT(in_dim=in_dim, n_classes=num_classes, **arch)
        torch.nn.init.normal_(model.cls_token, std=0.02)
    return model.to(device)


def gigapath_optimizer(model: LongNetViT, device, lr: float = 2e-3,
                       weight_decay: float = 0.05,
                       layer_decay: float = GIGAPATH_LAYER_DECAY
                       ) -> torch.optim.Optimizer:
    """AdamW over the layer-wise groups (each group's `lr_scale` kept for
    the schedule); the fused kernel on the card."""
    groups = param_groups(model, lr, weight_decay, layer_decay)
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             fused=torch.device(device).type == "cuda")


def _autocast(device):
    return torch.autocast("cuda", dtype=torch.bfloat16,
                          enabled=torch.device(device).type == "cuda")


def gigapath_train_step(model, opt, feats, coords, label: int,
                        device) -> torch.Tensor:
    """One slide: upload its tile features [N, D] (f32) and pixel
    coordinates [N, 2] (host arrays), CE of the logits under bf16 autocast
    on the card, backward, AdamW; all of it the `train/step` span."""
    model.train()
    with profiling.span("train/step", device=device):
        x = torch.as_tensor(feats).to(device, non_blocking=True)
        c = torch.as_tensor(coords).to(device, non_blocking=True)
        with _autocast(device):
            logits = model(x, c)
        loss = -F.log_softmax(logits.float(), -1)[0, label]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return loss.detach()


def gigapath_probs(model, feats, coords, device) -> np.ndarray:
    """softmax of one slide's logits, [num_classes]."""
    model.eval()
    with torch.no_grad(), _autocast(device):
        logits = model(torch.as_tensor(feats).to(device),
                       torch.as_tensor(coords).to(device))
    return torch.softmax(logits.float(), -1)[0].cpu().numpy()


def gigapath_coords(coords, ngrids: int = 1000,
                    tile_size: int = 256) -> List[np.ndarray]:
    """Each bag's `xy` grid cells (col, row) as LongNetViT's pixel
    coordinates (x tile_size). Refuses a bag without `xy`, cells off the
    ngrids x ngrids grid, and coordinates that are already pixels (every
    one a multiple of tile_size, some not 0)."""
    out = []
    for i, xy in enumerate(coords):
        if xy is None:
            raise SystemExit("gigapath needs each bag's tile coordinates "
                             f"(`xy` in its .npz); bag {i} has none")
        xy = np.asarray(xy, np.int64)
        if xy.size and (xy.min() < 0 or xy.max() >= ngrids):
            raise SystemExit(f"bag {i}: `xy` outside the [0, {ngrids}) tile "
                             "grid; `xy` holds grid cells (col, row), not "
                             "pixels")
        if xy.size and xy.any() and not (xy % tile_size).any():
            raise SystemExit(f"bag {i}: every `xy` is a multiple of "
                             f"{tile_size}: pixels, where `xy` holds grid "
                             "cells (col, row)")
        out.append(xy * tile_size)
    return out


def run_gigapath(args, bags, labels, coords):
    """gigapath k-fold: one slide a step, the folds, order and metrics of
    the other models."""
    dev = resolve_device(args.device)
    pixels = gigapath_coords(coords)
    rng = np.random.RandomState(args.seed)
    d = int(bags[0].shape[1])
    lr = hyper(args, "lr")

    def fit(train_idx):
        model = make_gigapath(d, args.num_classes, dev, args.seed)
        opt = gigapath_optimizer(model, dev, lr, hyper(args, "weight_decay"))

        def step(j):
            i = train_idx[j]
            gigapath_train_step(model, opt, bags[i], pixels[i],
                                int(labels[i]), dev)

        run_epochs(args, rng, len(train_idx), opt, step,
                   cosine_epoch_schedule(lr, args.epochs))
        return model

    def probs(model, i):
        return gigapath_probs(model, bags[i], pixels[i], dev)

    def save(model, fi):
        os.makedirs(args.save_dir, exist_ok=True)
        torch.save(model.state_dict(),
                   os.path.join(args.save_dir, f"gigapath_fold{fi}.pt"))

    return run_folds(args, labels, "gigapath", fit, probs, save)


# ------------------------------------------------------------------------- #
def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model",
                    choices=["abmil", "dsmil", "gtn", "h2mil", "gigapath"],
                    default="dsmil")
    ap.add_argument("--feats-dir", required=True)
    ap.add_argument("--labels", required=True, help="CSV name,label")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=None,
                    help="base rate (default 2e-4; gigapath 2e-3)")
    ap.add_argument("--weight-decay", type=float, default=None,
                    help="abmil/dsmil Adam L2 (default 5e-3) or gigapath "
                         "AdamW decay (default 0.05); gtn and h2mil fix "
                         "theirs at 5e-4")
    ap.add_argument("--num-classes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=100,
                    help="gtn mincut cluster count")
    ap.add_argument("--cell", type=int, default=4,
                    help="h2mil synthetic parent-level block size (tiles)")
    ap.add_argument("--k1", type=int, default=8)
    ap.add_argument("--k2", type=int, default=32)
    ap.add_argument("--dropout", type=float, default=0.3,
                    help="h2mil drop_out_ratio")
    ap.add_argument("--nested-bags", action="store_true",
                    help="h2mil: --feats-dir is a 2-level nested-bag image "
                         "directory")
    ap.add_argument("--encoder", default="random",
                    choices=["random", "kimia", "efficientnet-b4"],
                    help="nested-bag featurizer")
    ap.add_argument("--remix-mode", default=None,
                    choices=[None, "replace", "append", "interpolate", "cov",
                             "joint"])
    ap.add_argument("--remix-rate", type=float, default=0.3)
    ap.add_argument("--num-prototypes", type=int, default=8)
    ap.add_argument("--save-dir", default=None,
                    help="persist each fold's trained weights (pickle)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.weight_decay is not None and args.model in ("gtn", "h2mil"):
        raise SystemExit(f"--weight-decay: {args.model}'s is fixed at 5e-4")
    if resolve_device(args.device).type == "cuda":
        set_cuda_numerics()
    if args.nested_bags:
        if args.model != "h2mil":
            raise SystemExit("--nested-bags is an h2mil input mode")
        return run_h2mil(args, None, None, None)
    bags, labels, names, coords = load_bags(args.feats_dir, args.labels)
    if not bags:
        raise SystemExit("no bags found")
    print(f"{len(bags)} bags, classes: {np.bincount(labels)}")
    if args.model in ("abmil", "dsmil"):
        return run_bag_models(args, bags, labels)
    if args.model == "gtn":
        return run_gtn(args, bags, labels, coords)
    if args.model == "gigapath":
        return run_gigapath(args, bags, labels, coords)
    return run_h2mil(args, bags, labels, coords)


if __name__ == "__main__":
    main()
