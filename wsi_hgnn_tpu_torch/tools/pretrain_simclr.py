"""SimCLR contrastive pretraining and feature extraction with the port
(counterpart of tools/pretrain_simclr.py): the GTNMIL feature extractor.

  pretrain (default): KimiaNet (DenseNet-121) backbone, frozen, with a
  trainable 512-d projection head `fc_4`; NT-Xent at temperature 0.5 over
  two augmented views; Adam lr 1e-5 with coupled L2 1e-5 on the trained
  parameters; the LR constant through --warmup-epochs, then cosine
  (`simclr_lr_schedule`); a 0.1 validation split; `best.pkl` at each new
  best validation loss, in the JAX tool's dict (params, batch_stats,
  backbone, proj_dim, feat_dim, image_size), so either package reads it:
    python -m wsi_hgnn_tpu_torch.tools.pretrain_simclr --patch-dir corpus/ \\
        --out runs/simclr [--device cpu]
  extract: the trained encoder's backbone features (out_1) over per-slide
  bag directories, written as the train_mil bag contract (<slide>.npz:
  feat [N, D], xy tile coordinates):
    python -m wsi_hgnn_tpu_torch.tools.pretrain_simclr --extract \\
        --ckpt runs/simclr/best.pkl --patch-dir bags/ --out feats/
    python -m wsi_hgnn_tpu_torch.train_mil --model gtn --feats-dir feats/ ...

The frozen KimiaNet runs in inference mode through the fused f32 chain
(`fuse_kimianet(dtype=torch.float32)` + `kimianet_fused_apply`: every
dense layer and transition one hand-written kernel launch on the card,
their plain versions on the CPU), without autograd; `fc_4` is an
nn.Linear on its detached out_1. `--train-backbone` runs the `KimiaNet`
module instead. `--backbone tiny` (a 2-conv encoder, TF-SAME padded as
flax pads) is for smoke tests. The view draws come from a torch.Generator
seeded with --seed + 1 (validation batch s: --seed + 2 + s); the weights
from convert.init_flax_like_(--seed). Runs on the card unless --device
cpu.
"""
from __future__ import annotations

import argparse
import glob
import math
import os
import pickle
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import convert
from ..models.featurizers import KimiaNet, fuse_kimianet, kimianet_fused_apply
from ..models.mil.simclr import (coords_from_patch_names, simclr_loss,
                                 simclr_train_step)
from ..pipeline.patches import load_patch
from ..utils import resolve_device, set_cuda_numerics, to_torch

IMAGE_EXTS = ("jpeg", "jpg", "png")


def simclr_lr_schedule(lr0: float, epochs: int, steps_per_epoch: int,
                       warmup_epochs: int = 10) -> Callable[[int], float]:
    """lr(update count) of torch's CosineAnnealingLR(T_max=epochs,
    eta_min=0) stepped at the end of each epoch >= warmup_epochs: lr0
    through the warmup, then the cosine of the epochs stepped so far."""
    def lr(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        t = min(max(epoch - warmup_epochs, 0), epochs)
        return lr0 * 0.5 * (1.0 + math.cos(math.pi * t / max(epochs, 1)))
    return lr


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax/TF 'SAME' padding of NCHW for a k x k stride-s conv: the odd
    pixel goes after (a 256 input pads (0, 1))."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TinyEncoder(nn.Module):
    """A small conv encoder with KimiaNet's (out_1, out_3) contract:
    NHWC images -> (64-d features, proj_dim projection of the pooled
    convolution output)."""

    def __init__(self, proj_dim: int = 64):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 16, 3, stride=2)
        self.conv1 = nn.Conv2d(16, 32, 3, stride=2)
        self.feat = nn.Linear(32, 64)
        self.fc_4 = nn.Linear(32, proj_dim)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv0(_same_pad(x, 3, 2)))
        x = F.relu(self.conv1(_same_pad(x, 3, 2)))
        pooled = x.mean(dim=(2, 3))
        return self.feat(pooled), self.fc_4(pooled)


def build_model(backbone: str, proj_dim: int):
    """(module, feature dim): 'kimia' -> KimiaNet (out_1 1024-d, fc_4
    projection), 'tiny' -> TinyEncoder (64-d)."""
    if backbone == "kimia":
        return KimiaNet(num_classes=proj_dim), 1024
    if backbone == "tiny":
        return TinyEncoder(proj_dim), 64
    raise ValueError(f"backbone {backbone!r}")


def backbone_features(model: nn.Module, backbone: str,
                      device: torch.device
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """imgs [B, H, W, 3] f32 -> the backbone's out_1 [B, D], without
    autograd. KimiaNet runs fused in f32 (the hand-written kernels on the
    card); the tiny encoder runs its module."""
    if backbone == "kimia":
        fp = fuse_kimianet(convert.to_flax_variables(model),
                           dtype=torch.float32, device=device)

        @torch.no_grad()
        def fused(imgs):
            return kimianet_fused_apply(fp, imgs.float())[0]
        return fused

    @torch.no_grad()
    def module(imgs):
        return model(imgs)[0]
    return module


def make_projector(model: nn.Module, backbone: str, train_backbone: bool,
                   device: torch.device):
    """(project, trained parameters): project maps images to the fc_4
    projection. Unless train_backbone, only fc_4 trains and every other
    parameter is frozen (requires_grad off); a frozen KimiaNet then runs
    fused, fc_4 reading its out_1."""
    model.eval()   # BatchNorm in inference mode, as the JAX tool runs it
    trained = list(model.parameters() if train_backbone
                   else model.fc_4.parameters())
    keep = {id(p) for p in trained}
    for p in model.parameters():
        p.requires_grad_(id(p) in keep)
    if backbone == "kimia" and not train_backbone:
        feats = backbone_features(model, backbone, device)
        return (lambda imgs: model.fc_4(feats(imgs))), trained
    return (lambda imgs: model(imgs)[1]), trained


def list_corpus(patch_dir: str, exts=IMAGE_EXTS) -> list:
    paths = []
    for e in exts:
        paths += glob.glob(os.path.join(patch_dir, "**", "*." + e),
                           recursive=True)
    return sorted(paths)


def load_batch(paths, size: int) -> np.ndarray:
    return np.stack([load_patch(p, size) for p in paths])


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def save_checkpoint(path: str, model: nn.Module, backbone: str,
                    proj_dim: int, feat_dim: int, image_size: int) -> None:
    """best.pkl in the JAX tool's dict: flax-layout params and
    batch_stats ({} for the tiny encoder) plus the rebuild fields."""
    variables = convert.to_flax_variables(model)
    with open(path, "wb") as f:
        pickle.dump({"params": variables["params"],
                     "batch_stats": variables.get("batch_stats", {}),
                     "backbone": backbone, "proj_dim": proj_dim,
                     "feat_dim": feat_dim, "image_size": image_size}, f)


def load_checkpoint(path: str, device: torch.device):
    """(model on `device`, the checkpoint dict) of a best.pkl written by
    either package."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    model, _ = build_model(ckpt["backbone"], ckpt["proj_dim"])
    convert.load_flax_variables(model, {
        "params": ckpt["params"],
        "batch_stats": ckpt.get("batch_stats") or {}})
    return model.to(device).eval(), ckpt


def pretrain(args) -> str:
    dev = resolve_device(args.device)
    paths = list_corpus(args.patch_dir)
    if len(paths) < 2 * args.batch:
        raise SystemExit(f"need >= {2 * args.batch} patches, found "
                         f"{len(paths)}")
    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(paths))
    n_val = max(int(len(paths) * args.valid_size), args.batch)
    val_paths = [paths[i] for i in order[:n_val]]
    train_paths = [paths[i] for i in order[n_val:]]
    print(f"{len(train_paths)} train / {len(val_paths)} val patches")

    model, feat_dim = build_model(args.backbone, args.proj_dim)
    convert.init_flax_like_(model, args.seed)
    model.to(dev)
    project, trained = make_projector(model, args.backbone,
                                      args.train_backbone, dev)
    opt = torch.optim.Adam(trained, lr=args.lr, eps=1e-8,
                           weight_decay=args.wd)
    steps_per_epoch = max(len(train_paths) // args.batch, 1)
    lr_of = simclr_lr_schedule(args.lr, args.epochs, steps_per_epoch,
                               args.warmup_epochs)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    os.makedirs(args.out, exist_ok=True)
    best_path = os.path.join(args.out, "best.pkl")
    best_val, count = np.inf, 0
    for epoch in range(args.epochs):
        rng.shuffle(train_paths)
        for s in range(steps_per_epoch):
            imgs = load_batch(train_paths[s * args.batch:(s + 1) * args.batch],
                              args.image_size)
            _set_lr(opt, lr_of(count))
            loss = simclr_train_step(project, opt, to_torch(imgs, dev), gen)
            count += 1
        vlosses = []
        with torch.no_grad():
            for s in range(0, len(val_paths) - args.batch + 1, args.batch):
                imgs = load_batch(val_paths[s:s + args.batch],
                                  args.image_size)
                vgen = torch.Generator(device=dev).manual_seed(
                    args.seed + 2 + s)
                vlosses.append(float(simclr_loss(project,
                                                 to_torch(imgs, dev), vgen)))
        vloss = float(np.mean(vlosses)) if vlosses else float(loss)
        print(f"[{epoch + 1}/{args.epochs}] train_loss {float(loss):.3f} "
              f"val_loss {vloss:.3f}")
        if vloss < best_val:
            best_val = vloss
            save_checkpoint(best_path, model, args.backbone, args.proj_dim,
                            feat_dim, args.image_size)
            print("saved", best_path)
    return best_path


def slide_dirs(patch_dir: str) -> list:
    """The per-slide bag directories under patch_dir (or patch_dir itself
    when it has none)."""
    return sorted(d for d in glob.glob(os.path.join(patch_dir, "*"))
                  if os.path.isdir(d)) or [patch_dir]


def extract(args) -> list:
    """out_1 features of every slide directory's images -> <out>/<slide>.npz
    (feat, and xy when every name is `{col}_{row}.<ext>`). Returns the
    files written."""
    dev = resolve_device(args.device)
    model, ckpt = load_checkpoint(args.ckpt, dev)
    size = ckpt.get("image_size", 256)
    feats_fn = backbone_features(model, ckpt["backbone"], dev)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for d in slide_dirs(args.patch_dir):
        paths = sorted(p for p in glob.glob(os.path.join(d, "*"))
                       if os.path.isfile(p)
                       and p.rsplit(".", 1)[-1] in IMAGE_EXTS)
        if not paths:
            continue
        feats = np.concatenate([
            feats_fn(to_torch(load_batch(paths[s:s + args.batch], size),
                              dev)).cpu().numpy()
            for s in range(0, len(paths), args.batch)]).astype(np.float32)
        try:
            xy = np.asarray(coords_from_patch_names(
                [os.path.basename(p) for p in paths]), np.int64)
        except ValueError:
            xy = None
        out = os.path.join(args.out, os.path.basename(d) + ".npz")
        if xy is not None:
            np.savez(out, feat=feats, xy=xy)
        else:
            np.savez(out, feat=feats)
        print(f"{out}: {feats.shape}")
        written.append(out)
    return written


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--patch-dir", required=True,
                    help="pretrain: a patch corpus (recursive); extract: "
                         "per-slide bag dirs")
    ap.add_argument("--out", required=True)
    ap.add_argument("--extract", action="store_true")
    ap.add_argument("--ckpt", default=None, help="extract: best.pkl path")
    ap.add_argument("--backbone", default="kimia", choices=["kimia", "tiny"])
    ap.add_argument("--proj-dim", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--wd", type=float, default=1e-5)
    ap.add_argument("--valid-size", type=float, default=0.1)
    ap.add_argument("--warmup-epochs", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-backbone", action="store_true",
                    help="train the full encoder (the reference freezes "
                         "the backbone; use for the tiny smoke backbone)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        set_cuda_numerics()
    if args.extract:
        if not args.ckpt:
            raise SystemExit("--extract needs --ckpt")
        return extract(args)
    return pretrain(args)


if __name__ == "__main__":
    main()
