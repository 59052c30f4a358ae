#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`wsi_hgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, one card, exit 0 when all holds

1. Prints the card (`nvidia-smi` name and power limit) and builds every
   CUDA kernel from `wsi_hgnn_tpu_torch/csrc` with nvcc for sm_90a, one
   nvcc per source, all at once; prints the bf16 DenseNet kernels' blocks
   per SM and shared memory (`--ptxas` adds nvcc's register report).
2. Kernel phases: each kernel against its plain PyTorch version at the
   main path's shapes (the bf16 dense layer at all 58 layers of a
   128-patch chunk; the KNN bit-equal on exact data, with ragged, tiny
   and all-ties slides, and at every size N = 384 .. 16384), with the
   tolerance printed beside the error.
3. The slice: `SlidePredictor` at the width of
   configs/BRCA/HEAT4_kimia_classification.yml, pixels in (KimiaNet
   features + HoVer-Net typing, bf16), exact KNN + Pearson lattice,
   HEAT4, softmax; requests of 2048, 1000 and 300 patches. The kernel
   launch counters are zeroed just before and read just after.
4. Timing lines (CUDA events per kernel launch, one line per main-path
   shape: each KNN size, each dense block, each transition, with
   ms/launch, bound and share of the bound; host clock per stage),
   and a torch.profiler pass over the last request: the device's busy
   share and the kernels that took the most device time.
5. The training slice at the same width, read from that config file:
   12 seeded synthetic slides of 1000-3000 patches whose graphs are
   built on the card (one KNN launch each) and written as `.npz`;
   `GNNTrainer` for 2 epochs on the lattice, `HomoGraphEvaluator` on the
   checkpoint it wrote, `SlidePredictor(checkpoint_path=)` on the test
   slides, and one train step on the card against the same step on the
   CPU. Counters are zeroed before the dataset is built and read after
   the evaluation.
6. The zoo on the same cohort (also written untyped for the homogeneous
   models): GCN, GAT, GIN, GCN_NTPool, HetRGCN and HGT at the width of
   their configs/BRCA/<name>_kimia_classification.yml, and HEAT4 with
   `train.lattice: off`, each through `GNNTrainer` on the TypedGraph
   path (1 epoch, HGT 2), `HomoGraphEvaluator` (equal to the trainer's
   last test metrics), `SlidePredictor(checkpoint_path=)` on the test
   slides' features with each graph rebuilt on the card (equal to the
   evaluator, one KNN launch per slide), and one step on the card
   against the CPU; ms per train step, eval ms per slide and peak device
   memory per family, and a torch.profiler pass over one HGT step.
   Counters are zeroed before the phase and read after it.

7. The server: the slice's predictor (served from a version-1
   checkpoint, pixels enabled) behind `BatchingServer` on 127.0.0.1:0:
   8 clients x 4 feature requests of distinct 2048-patch slides, then 2
   concurrent 300-patch pixel requests, every answer equal to the same
   slide served alone; 400 and 413 replies, /healthz and /stats; slides/s,
   latency p50/p95, group sizes, decode ms and (a third run, profiled)
   the device busy share.
8. Construction: configs/GraphConstruction/BRCA_HovernetKimia_graph_
   constructor.yml with its paths redirected, `construct_all` on the card
   over 3 seeded JPEG slides with KimiaNet and HoVer-Net read from files
   written under the reference's key names, then `generate_splits`; one
   slide's features against the encoder given the same weights as flax
   variables, its graph against the CPU plain path, a `GNNTrainer` epoch
   on the written files; seconds per slide by stage.
9. Tiling and the other encoders (tile_build, after 8.): a seeded
   8192x6144 slide image tiled by `python -m
   wsi_hgnn_tpu_torch.get_patches` (PIL backend, spawned workers), then
   `construct_all` on the card over its tiles with
   configs/GraphConstruction/COAD_Hovernet_graph_constructor.yml
   ('hover': HoVer-Net with its fc1 at 1024, seeded on the card) and with
   BRCA_HovernetEfficient_graph_constructor.yml (EfficientNet-B4 and
   inline typing from seeded weight files); ms per slide by stage, ms per
   patch in the encoder, peak memory, busy share and KNN launches per
   config, each CNN on the card against the CPU in f32 and the written
   bf16 features against the CPU's f32.
The zoo (6.) also trains, evaluates and serves GCN with ASAP pooling
(configs/BRCA/GCN_asap_classification.yml). The card-vs-CPU steps compare
every parameter's gradient, with a float64 CPU step as the judge of
misses the f32 arithmetic explains (GRAD_RTOL, GRAD_F32). Counters are
zeroed before each phase's main path and read after it.

The line before the last is the kernels JSON (launches summed over the
served requests, the server traffic, the training slice, the zoo's
served slides and the constructions), the last line the device JSON. Any
failed check exits non-zero. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


class CheckFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the type's peak."""
    t_b = bytes_moved / PEAK_BYTES * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def mean_bound(bounds):
    """Mean per-launch bound of launches at differing shapes, each launch
    bound on its own; labelled by what bounds most of their summed time."""
    total = sum(t for t, _ in bounds)
    by_bytes = sum(t for t, by in bounds if by == "bytes")
    return total / len(bounds), "bytes" if 2 * by_bytes >= total else "operations"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
BLOCKS = ((64, 64, 6), (32, 128, 12), (16, 256, 24), (8, 512, 16))  # (H, ch_in, layers)
CHUNK = 128


KNN_SIZES = (384, 1024, 2048, 4096, 8192, 16384)  # buckets up to 10^4 patches
KNN_MAIN = 2048      # the 2048-patch request's bucket: the summary row
KNN_D, KNN_K = 1024, 8
# (N, live rows, kind): planted duplicate rows, a ragged N across split
# boundaries, a slide with fewer live candidates than k, all rows equal
KNN_EXACT = ((2048, 2000, "ties"), (384, 300, "ties"), (3000, 2900, "ties"),
             (384, 5, "ties"), (2048, 1900, "equal"))


def knn_exact_features(torch, gen, n, kind):
    """Small integers: every product and sum is exact in f32, so any
    summation order gives the same bits. 'ties' plants duplicate rows
    (exact ties); 'equal' repeats one row, so every distance ties."""
    f = torch.randint(-8, 9, (n, KNN_D), generator=gen,
                      dtype=torch.int32).float()
    if kind == "equal":
        f[:] = f[0]
    else:
        f[1::7] = f[0:n - 1:7][: f[1::7].shape[0]]
    return f


def knn_phase(torch, kn, knn_ops, dev, gen, card):
    """Exact-arithmetic inputs: indices and distances must be EXACTLY equal
    to the plain version's. Gaussian inputs at every size: distances to
    1e-5 relative, index mismatches only where two distances tie within
    that. Then one timing line per size. From N = STREAM_THRESHOLD on, the
    plain version is the streaming `knn_l2_tiled` (no [N, N] matrix)."""
    def plain_of(n):
        return (kn.knn_l2_reference if n < knn_ops.STREAM_THRESHOLD
                else knn_ops.knn_l2_tiled)

    for n, n_real, kind in KNN_EXACT:
        f = knn_exact_features(torch, gen, n, kind).to(dev)
        mask = torch.arange(n, device=dev) < n_real
        i_k, d_k = kn.knn_l2_fused(f, KNN_K, mask)
        i_p, d_p = plain_of(n)(f, KNN_K, mask)
        torch.cuda.synchronize()
        what = f"(exact data, N={n}, mask {n_real}, {kind})"
        check(torch.equal(i_k, i_p), f"knn idx differs {what}")
        check(torch.equal(d_k, d_p), f"knn d2 differs {what}")
        if kind == "equal":
            check(bool((i_k[:, 1:] > i_k[:, :-1]).all()),
                  f"knn ties not in index order {what}")
        log(f"knn N={n} mask={n_real} {kind}: exact data idx+d2 equal")
    worst, per_shape, main = 0.0, [], None
    for n in KNN_SIZES:
        plain = plain_of(n)
        g = torch.randn(n, KNN_D, generator=gen).to(dev)
        mask = torch.arange(n, device=dev) < n - n // 32
        i_k, d_k = kn.knn_l2_fused(g, KNN_K, mask)
        i_p, d_p = plain(g, KNN_K, mask)
        err = (d_k - d_p).abs().max().item()
        rel = ((d_k - d_p).abs() / d_p.abs().clamp_min(1e-6)).max().item()
        mism = int((i_k != i_p).sum().item())
        check(rel <= 1e-5, f"knn d2 rel err {rel:.3g} > 1e-5 (N={n})")
        log(f"knn N={n} gaussian, plain version {plain.__name__}: max|d2 err|"
            f" {err:.3g} (rel {rel:.3g} <= 1e-5), {mism} index swaps at "
            f"near-ties")
        worst = max(worst, err)
        reps = max(3, min(30, 40000 // n))
        ms = cuda_ms(lambda: kn.knn_l2_fused(g, KNN_K), reps=reps)
        plain_ms = cuda_ms(lambda: plain(g, KNN_K), reps=reps)
        # operations: the Gram matrix is symmetric (q.c and c.q, summed in
        # one feature order, are the same bits), so the function needs its
        # upper triangle only, diagonal (the row norms) included
        b_ms, b_by = bound(n * KNN_D * 4 + n * 4 + n * KNN_K * 8,
                           float(n * (n + 1) * KNN_D), "float32")
        per_shape.append(shape_line(
            "knn_l2_fused", f"N={n} D={KNN_D} k={KNN_K}", 1, ms,
            [(b_ms, b_by)], card, plain_ms=plain_ms))
        if n == KNN_MAIN:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return dict(max_abs_err=worst, **main, per_shape=per_shape)


def layer_operands(torch, dev, gen, h, c_end, k_in, dtype):
    """Random operands of one dense layer at activation scale ~1, made on
    the card from the device generator `gen`."""
    kw = dict(generator=gen, device=dev)
    x = torch.zeros(CHUNK, h, h, c_end, device=dev)
    x[..., :k_in] = torch.randn(CHUNK, h, h, k_in, **kw)
    a1 = torch.zeros(1, c_end, device=dev)
    b1 = torch.zeros(1, c_end, device=dev)
    a1[0, :k_in] = torch.rand(k_in, **kw) + 0.5
    b1[0, :k_in] = torch.randn(k_in, **kw) * 0.1
    w1f = torch.zeros(c_end, 128, device=dev)
    w1f[:k_in] = torch.randn(k_in, 128, **kw) * (2.0 / k_in) ** 0.5
    b2 = torch.randn(1, 128, **kw) * 0.1
    w2cat = torch.randn(128, 288, **kw) * (2.0 / 1152) ** 0.5
    return x.to(dtype), a1, b1, w1f.to(dtype), b2, w2cat.to(dtype)


# stated tolerances: f32 differs from the plain version by summation order
# only; bf16 outputs carry 8 mantissa bits and v is rounded to bf16 before
# the 3x3 conv, so one flipped rounding moves y by a few bf16 ulps
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 3e-2)}  # (rtol, atol)


def close(torch, got, want, dtype):
    rtol, atol = TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all().item())
    return ok, err.max().item()


def check_layer(torch, dn, ops, h, k_in, name):
    """One dense layer, kernel against plain version on the same operands:
    the prefix untouched, channels past the slot still 0, the slot within
    the stated tolerance. Returns the slot's max abs error."""
    kw = dict(n_active_groups=-(-k_in // 128), slot=k_in // 32)
    got = dn.dense_layer_fused(ops[0].clone(), *ops[1:], **kw)
    want = dn.dense_layer_reference(ops[0].clone(), *ops[1:], **kw)
    torch.cuda.synchronize()
    check(torch.equal(got[..., :k_in], ops[0][..., :k_in])
          and not got[..., k_in + 32:].any(),
          f"dense layer touched channels outside its slot "
          f"(H={h}, k_in={k_in}, {name})")
    ok, err = close(torch, got[..., k_in:k_in + 32],
                    want[..., k_in:k_in + 32], name)
    check(ok, f"dense layer mismatch H={h} k_in={k_in} {name}: "
          f"max|err| {err:.3g}")
    return err


def shape_line(kernel, shape, n, ms, bounds, card, plain_ms=None):
    """Log and return the per-shape timing of `n` launches whose summed
    time is `ms`: mean ms/launch, summed and mean bound, share of bound,
    and the plain version's ms/launch where it was timed."""
    b_ms, b_by = mean_bound(bounds)
    per = ms / n
    plain = "" if plain_ms is None else f"; plain {plain_ms:.4g} ms/launch"
    log(f"timing {kernel} {shape}: {per:.4g} ms/launch x {n}, bound "
        f"{b_ms * n:.4g} ms summed ({b_by}), share of bound "
        f"{b_ms / per:.4g}{plain} [{card}]")
    row = dict(shape=shape, launches_per_chunk=n, ms=per, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / per)
    if plain_ms is not None:
        row["plain_ms"] = plain_ms
    return row


def dense_phase(torch, dn, dev, gen, card):
    """f32 at the first and last layer of each dense block; bf16 (the main
    path) at every one of one chunk's 58 layers. Then every block's layers
    are timed in bf16, block by block."""
    for h, ch, n_layers in BLOCKS:
        c_end = ch + 32 * n_layers
        for li in (0, n_layers - 1):
            k_in = ch + 32 * li
            ops = layer_operands(torch, dev, gen, h, c_end, k_in,
                                 torch.float32)
            err = check_layer(torch, dn, ops, h, k_in, "float32")
            log(f"dense_layer H={h} k_in={k_in} C_end={c_end} float32: "
                f"max|err| {err:.3g} (rtol,atol {TOL['float32']})")
    worst, blocks = 0.0, []
    for h, ch, n_layers in BLOCKS:
        c_end = ch + 32 * n_layers
        layers, bounds, errs = [], [], []
        for li in range(n_layers):
            k_in = ch + 32 * li
            ops = layer_operands(torch, dev, gen, h, c_end, k_in,
                                 torch.bfloat16)
            errs.append(check_layer(torch, dn, ops, h, k_in, "bfloat16"))
            x = ops[0] if not layers else layers[0][0]
            layers.append((x,) + ops[1:] + (k_in,))
            px = CHUNK * h * h
            bounds.append(bound(
                px * (k_in + 32) * 2 + (k_in * 128 + 128 * 288) * 2,
                2.0 * px * (k_in * 128 + 9 * 128 * 32), "bfloat16"))
        log(f"dense_layer H={h} C_end={c_end} bfloat16, all {n_layers} "
            f"layers (k_in {ch}..{ch + 32 * (n_layers - 1)}): max|err| "
            f"{max(errs):.3g} (rtol,atol {TOL['bfloat16']})")
        worst = max(worst, max(errs))
        blocks.append((h, c_end, layers, bounds))

    def run(fn, layers):
        def go():
            for x, a1, b1, w1f, b2, w2cat, k_in in layers:
                fn(x, a1, b1, w1f, b2, w2cat,
                   n_active_groups=-(-k_in // 128), slot=k_in // 32)
        return go
    per_shape, total_ms, all_layers, all_bounds = [], 0.0, [], []
    for h, c_end, layers, bounds in blocks:
        ms = cuda_ms(run(dn.dense_layer_fused, layers), reps=3, warmup=1)
        k_lo, k_hi = layers[0][-1], layers[-1][-1]
        per_shape.append(shape_line(
            "dense_layer_fused", f"[{CHUNK},{h},{h},{c_end}] k_in {k_lo}..{k_hi}",
            len(layers), ms, bounds, card))
        total_ms += ms
        all_layers += layers
        all_bounds += bounds
    n_l = len(all_layers)
    plain = cuda_ms(run(dn.dense_layer_reference, all_layers), reps=1,
                    warmup=1) / n_l
    b_ms, b_by = mean_bound(all_bounds)
    return dict(max_abs_err=worst, ms=total_ms / n_l, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, per_shape=per_shape)


def transition_phase(torch, dn, dev, gen, card):
    worst, shapes = 0.0, []
    for h, c in ((64, 256), (32, 512), (16, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            kw = dict(generator=gen, device=dev)
            x = torch.randn(CHUNK, h, h, c, **kw).to(dtype)
            a = torch.rand(1, c, **kw) + 0.5
            b = torch.randn(1, c, **kw) * 0.1
            w = (torch.randn(c, c // 2, **kw) * (2.0 / c) ** 0.5).to(dtype)
            got = dn.transition_fused(x, a, b, w)
            want = dn.transition_reference(x, a, b, w)
            torch.cuda.synchronize()
            ok, err = close(torch, got, want, name)
            log(f"transition [{CHUNK},{h},{h},{c}] {name}: max|err| "
                f"{err:.3g} (rtol,atol {TOL[name]})")
            check(ok, f"transition mismatch H={h} C={c} {name}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                shapes.append((x, a, b, w))
    per_shape, total_ms, bounds = [], 0.0, []
    for x, a, b, w in shapes:
        bsz, h, _, c = x.shape
        m = bsz * (h // 2) * (h // 2)
        bounds.append(bound(
            x.numel() * 2 + w.numel() * 2 + m * (c // 2) * 2 + 8 * c,
            2.0 * m * c * (c // 2) + 4.0 * m * 4 * c, "bfloat16"))
        ms = cuda_ms(lambda: dn.transition_fused(x, a, b, w), reps=10)
        per_shape.append(shape_line(
            "transition_fused", f"[{bsz},{h},{h},{c}]->{c // 2}", 1, ms,
            bounds[-1:], card))
        total_ms += ms
    plain = cuda_ms(lambda: [dn.transition_reference(*s) for s in shapes],
                    reps=3)
    b_ms, b_by = mean_bound(bounds)
    return dict(max_abs_err=worst, ms=total_ms / 3, plain_ms=plain / 3,
                bound_ms=b_ms, bound_by=b_by, per_shape=per_shape)


KERNELS = (
    ("knn_l2_fused", "wsi_hgnn_tpu_torch/csrc/knn.cu",
     "wsi_hgnn_tpu/ops/pallas_knn.py:101"),
    ("dense_layer_fused", "wsi_hgnn_tpu_torch/csrc/dense_layer.cu",
     "wsi_hgnn_tpu/ops/pallas_densenet.py:126"),
    ("transition_fused", "wsi_hgnn_tpu_torch/csrc/transition.cu",
     "wsi_hgnn_tpu/ops/pallas_densenet.py:183"),
)


# ---------------------------------------------------------------------------
# the slice: pixels in, probabilities out
# ---------------------------------------------------------------------------
# GNN section of configs/BRCA/HEAT4_kimia_classification.yml, as written there
GNN = {"name": "HEAT4", "n_node_types": 6, "num_meta_paths": 3,
       "num_layers": 2, "in_dim": 1024, "hidden_dim": 512, "out_dim": 2,
       "n_heads": 4, "num_out_heads": 1, "feat_drop": 0.2,
       "graph_pooling_type": "mean"}
RADIUS = 9                 # k = 8, the BRCA graph-construction operating point
N_TYPES = 6
PATCH = 256
REQUESTS = ((2048, 2048), (1000, 1024), (300, 384))   # (patches, size bucket)
PER_CHUNK = {"dense_layer_fused": 58, "transition_fused": 3}
N_CHECK = 8                # patches of the small-input reference checks


def patch_pool(n: int, seed: int):
    """n seeded uint8 RGB patches [n, 256, 256, 3]."""
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, 256, (n, PATCH, PATCH, 3), dtype=np.uint8)


def slice_phase(torch, dev, card, kernels, root: Path, gnn=GNN,
                requests=REQUESTS, chunk=CHUNK):
    """Serve one pixel request per entry of `requests` through
    SlidePredictor (seeded GNN weights written as a version-1 checkpoint
    under `root` and served from it), check the answers and the kernel
    launch counts, hold the card's answers against plain references on
    small inputs, and time the first request stage by stage. Returns the
    launch counts of the served requests and the predictor."""
    import numpy as np

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import parse_lattice_twin
    from wsi_hgnn_tpu_torch.models.featurizers import (
        HoVerNet, KimiaNet, fuse_kimianet, hovernet_typing_apply,
        kimianet_fused_apply)
    from wsi_hgnn_tpu_torch.models.featurizers import _norm_pixels
    from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
    from wsi_hgnn_tpu_torch.serve import SlidePredictor
    from wsi_hgnn_tpu_torch.train.checkpoint import CheckpointManager
    from wsi_hgnn_tpu_torch.utils import to_torch

    t0 = time.perf_counter()
    cfg = {"GNN": gnn, "checkpoint": {"path": str(root / "slice_ckpt")}}
    gnn_vars = convert.to_flax_variables(
        convert.init_flax_like_(parse_lattice_twin(gnn), seed=0))
    CheckpointManager(cfg["checkpoint"]["path"]).write_new_version(
        cfg, {"params": gnn_vars["params"], "batch_stats": {}}, {"Epoch": 1})
    kimia = convert.init_flax_like_(KimiaNet(), seed=1).eval()
    kimia_vars = convert.to_flax_variables(kimia)
    hover = convert.init_flax_like_(HoVerNet.typing(N_TYPES, "fast"),
                                    seed=2).eval()
    hover_vars = convert.to_flax_variables(hover)
    pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                          device=dev)
    check(pred.version == 1, f"predictor serves version {pred.version}")
    pred.enable_pixels(hovernet_config={"batch_size": chunk, "mode": "fast"},
                       kimia_variables=kimia_vars,
                       hover_variables=hover_vars)
    pred.warmup_pixels(requests[0][0])
    slides = [patch_pool(n, seed=10 + i) for i, (n, _) in enumerate(requests)]
    log(f"slice set-up (seeded weights, warm-up, patch pools) "
        f"{time.perf_counter() - t0:.1f} s; GNN {gnn['name']} in "
        f"{gnn['in_dim']} hidden {gnn['hidden_dim']} heads {gnn['n_heads']} "
        f"layers {gnn['num_layers']}, radius {RADIUS}, chunk {chunk}")

    # record what featurize hands to the graph stage, to check node types
    featurized = []
    featurize = pred.featurize

    def recording_featurize(px):
        out = featurize(px)
        featurized.append(out)
        return out

    pred.featurize = recording_featurize

    # ---- the main path: counters from 0, one request per slide ----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    probs, seconds, per_request = [], [], []
    for px in slides:
        before = kernels.launch_counts()
        t = time.perf_counter()
        probs.append(pred.predict_many_pixels([px]))
        seconds.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        per_request.append({k: after[k] - before[k] for k in after})
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pred.featurize = featurize

    for (n, cap), p, (f, ty), got, s in zip(requests, probs, featurized,
                                            per_request, seconds):
        n_chunks = -(-n // chunk)
        want = {"knn_l2_fused": 1,
                **{k: v * n_chunks for k, v in PER_CHUNK.items()}}
        log(f"request {n} patches (bucket {pred.pack([(f, ty)])[0].shape[1]})"
            f": {s * 1e3:.1f} ms, probs {p[0].tolist()}, node types "
            f"{np.bincount(ty, minlength=N_TYPES).tolist()}, launches {got}")
        check(got == want, f"{n}-patch request launched {got}, want {want}")
        check(pred.pack([(f, ty)])[0].shape[1] == cap,
              f"{n}-patch request not padded to bucket {cap}")
        check(p.shape == (1, int(gnn["out_dim"])) and np.isfinite(p).all()
              and abs(float(p.sum()) - 1.0) <= 1e-5,
              f"{n}-patch probabilities {p} not finite or not summing to 1")
        check(f.shape == (n, int(gnn["in_dim"])) and np.isfinite(f).all(),
              f"{n}-patch features not finite [{n}, {gnn['in_dim']}]")
        check(ty.shape == (n,) and ((ty >= 0) & (ty < N_TYPES)).all(),
              f"{n}-patch node types outside [0, {N_TYPES})")

    # ---- the card's answers against plain references on small inputs -----
    # GNN: the CPU predictor (plain KNN, f32 everywhere) on the last
    # request's own features; differs by summation order only
    cpu = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                         variables=gnn_vars, device="cpu")
    err = float(np.abs(probs[-1] - cpu.predict_many([featurized[-1]])).max())
    log(f"HEAT4 probabilities, card vs CPU plain path ({requests[-1][0]} "
        f"patches): max|err| {err:.3g} (atol 1e-4)")
    check(err <= 1e-4, f"card probabilities differ from the CPU path by {err}")

    x = _norm_pixels(to_torch(slides[-1][:N_CHECK], dev))
    with torch.inference_mode():
        # KimiaNet: the kernel chain in f32 storage vs the unfused module
        want1, _ = kimia.to(dev)(x)
        got1, _ = kimianet_fused_apply(
            fuse_kimianet(kimia_vars, dtype=torch.float32, device=dev), x)
        err = (got1 - want1).abs().max().item()
        ok = bool(torch.allclose(got1, want1, rtol=1e-3, atol=1e-4))
        log(f"KimiaNet fused kernels f32 vs unfused module: max|err| {err:.3g}"
            f" (rtol 1e-3, atol 1e-4)")
        check(ok, "fused KimiaNet (f32 kernels) differs from the module")
        # the served bf16 features vs the f32 module: 8-bit mantissas
        # through 58 dense layers, a few percent at most
        bf = torch.from_numpy(featurized[-1][0][:N_CHECK]).to(dev)
        rel = float(((bf - want1).norm(dim=1) / want1.norm(dim=1)).max())
        log(f"KimiaNet served bf16 features vs f32 module: max relative L2 "
            f"error {rel:.3g} (<= 0.1)")
        check(rel <= 0.1, f"bf16 features off by {rel} relative")
        # HoVer-Net: served bf16 typing vs the f32 module (reported: with
        # random weights a near-even class vote may flip)
        types32 = hovernet_typing_apply(hover.to(dev), x, N_TYPES).cpu().numpy()
        agree = int((types32 == featurized[-1][1][:N_CHECK]).sum())
        log(f"HoVer-Net served bf16 node types equal the f32 module's on "
            f"{agree}/{len(types32)} patches")

    # ---- stage by stage, the first request (host clock, synchronised) ----
    n0 = requests[0][0]
    enc = pred._encoder
    chunks = [to_torch(slides[0][i:i + chunk], dev) for i in range(0, n0, chunk)]
    stage_ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t) * 1e3
        return out

    with torch.inference_mode():
        for name in ("hovernet", "kimianet"):
            timed(name, lambda: [enc.stages[name](_norm_pixels(c))
                                 for c in chunks])
        feats, ntypes, mask = (to_torch(a, dev)
                               for a in pred.pack([featurized[0]]))
        g = timed("graph", lambda: build_lattice_device(
            feats, ntypes, mask, RADIUS, N_TYPES))
        timed("heat4", lambda: torch.softmax(pred.model(g), -1))
    total = seconds[0] * 1e3
    log(f"timing stages of the {n0}-patch request: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stage_ms.items())
        + f"; served request {total:.1f} ms ({1e3 / total:.4g} slides/s, "
        f"{total / n0:.4g} ms/patch), stages sum {sum(stage_ms.values()):.1f}"
        f" ms; peak device memory {peak_gib:.2f} GiB [{card}]")
    profile_span(torch, lambda: pred.predict_many_pixels([slides[-1]]),
                 f"the {requests[-1][0]}-patch request", card)
    return launches, pred


# ---------------------------------------------------------------------------
# the server: the slice's predictor behind the micro-batching HTTP server
# ---------------------------------------------------------------------------
SERVER_CLIENTS, SERVER_PER_CLIENT = 8, 4     # 8 clients, 4 requests each
SERVER_N = 2048                              # patches per feature slide
SERVER_PIXELS = (300, 300)                   # concurrent pixel requests
SERVER_MAX_BATCH, SERVER_WAIT_MS = 8, 5.0


def npz_body(**arrays) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def post(port: int, body: bytes, timeout: float = 300.0):
    """POST /predict: (status, JSON reply, client latency ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read() or b"{}")
    return code, out, (time.perf_counter() - t) * 1e3


def get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def declared_too_big(port: int, length: int) -> int:
    """Status of a POST that declares `length` body bytes and sends none:
    the server must refuse it before reading."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
        return conn.getresponse().status
    finally:
        conn.close()


def client_load(port: int, bodies, clients: int):
    """`clients` threads, each POSTing its share of `bodies` one after
    another: ([(status, reply, latency ms)] in body order, wall seconds)."""
    import threading

    results = [None] * len(bodies)

    def client(c):
        for i in range(c, len(bodies), clients):
            results[i] = post(port, bodies[i])

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "a server client did not finish")
    return results, time.perf_counter() - t0


def server_phase(torch, dev, card, kernels, pred, n=SERVER_N,
                 pixels=SERVER_PIXELS, chunk=CHUNK):
    """The slice's predictor (pixels enabled) behind BatchingServer on
    127.0.0.1:0: 8 clients x 4 feature requests of distinct seeded
    n-patch slides, then 2 concurrent pixel requests, each answer held
    against the same slide served alone through the predictor (1e-4);
    a malformed body (400) and a declared body over max_body_mb (413);
    /healthz's version and /stats' counts. Counters are zeroed before the
    timed traffic and read after it; a third feature run is profiled.
    Returns the launch counts of the timed traffic."""
    import numpy as np

    from wsi_hgnn_tpu_torch.serve import BatchingServer

    rng = np.random.RandomState(20)
    d = pred.in_dim
    n_req = SERVER_CLIENTS * SERVER_PER_CLIENT
    slides = [(rng.randn(n, d).astype(np.float32),
               rng.randint(0, N_TYPES, n).astype(np.int32))
              for _ in range(n_req)]
    px = [patch_pool(p, seed=30 + i) for i, p in enumerate(pixels)]
    alone = [pred.predict(f, t) for f, t in slides]
    px_alone = [pred.predict_many_pixels([p])[0] for p in px]
    bodies = [npz_body(features=f, node_types=t) for f, t in slides]
    px_bodies = [npz_body(pixels=p) for p in px]
    server = BatchingServer(pred, max_batch=SERVER_MAX_BATCH,
                            max_wait_ms=SERVER_WAIT_MS, pad_batches=True,
                            max_body_mb=256.0)
    server.warmup(n)
    server.start()
    port = server.port
    try:
        health = get(port, "/healthz")
        check(health == {"status": "ok", "model_version": 1},
              f"/healthz {health}, want version 1")
        client_load(port, bodies, SERVER_CLIENTS)   # warm: batch shapes
        before = get(port, "/stats")
        # ---- the main path: counters from 0 -------------------------------
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results, wall = client_load(port, bodies, SERVER_CLIENTS)
        px_results, px_wall = client_load(port, px_bodies, len(px))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        after = get(port, "/stats")
        bad = post(port, b"not-an-npz")[0]
        big = declared_too_big(port, server.max_body + 1)
        profile_span(torch, lambda: client_load(port, bodies, SERVER_CLIENTS),
                     f"{n_req} feature requests from {SERVER_CLIENTS} "
                     f"clients", card)
    finally:
        server.stop()

    errs = []
    for (code, out, _), want in zip(results + px_results, alone + px_alone):
        check(code == 200, f"server answered {code}: {out}")
        errs.append(float(np.abs(np.asarray(out["probs"]) - want).max()))
    err = max(errs)
    check(err <= 1e-4, f"served answers differ from the lone-slide answers "
          f"by {err}")
    check(bad == 400 and big == 413,
          f"malformed body got {bad} (want 400), oversized {big} (want 413)")
    sent = n_req + len(px)
    delta = {k: after[k] - before[k] for k in ("requests", "batches",
                                                "errors", "decode_ms_sum")}
    check(delta["requests"] == sent and delta["errors"] == 0,
          f"/stats counted {delta}, want {sent} requests, 0 errors")
    chunks = sum(-(-p // chunk) for p in pixels)
    want = {"knn_l2_fused": SERVER_MAX_BATCH * delta["batches"],
            **{k: v * chunks for k, v in PER_CHUNK.items()}}
    check(launches == want, f"server traffic launched {launches}, want "
          f"{want} (every group padded to {SERVER_MAX_BATCH} slides)")
    lat = np.array([r[2] for r in results])
    log(f"server: {n_req} feature requests ({SERVER_CLIENTS} clients x "
        f"{SERVER_PER_CLIENT}, {n} x {d} f32 + node types) and "
        f"{len(px)} pixel requests of {pixels[0]} patches; answers vs the "
        f"lone slide max|err| {err:.3g} (atol 1e-4); 400 and 413 replies; "
        f"/stats {delta['requests']} requests in {delta['batches']} groups, "
        f"batched_requests_max {after['batched_requests_max']}; launches "
        f"{launches} [{card}]")
    log(f"timing server: {n_req / wall:.4g} slides/s under {SERVER_CLIENTS}"
        f" clients ({wall:.3f} s for {n_req} {n}-patch feature slides), "
        f"latency per request p50 {np.percentile(lat, 50):.1f} ms / p95 "
        f"{np.percentile(lat, 95):.1f} ms / max {lat.max():.1f} ms, mean decode "
        f"{delta['decode_ms_sum'] / delta['requests']:.2f} ms per request; "
        f"pixel requests {px_wall:.3f} s for {len(px)} concurrent "
        f"(latency {max(r[2] for r in px_results):.1f} ms) "
        f"(max_batch {SERVER_MAX_BATCH}, max_wait_ms {SERVER_WAIT_MS}, "
        f"pad_batches on) [{card}]")
    return launches


PORT_KERNELS = ("knn_l2", "dense_layer", "transition")   # csrc kernel names


def profile_span(torch, fn, what: str, card: str, top: int = 12):
    """torch.profiler over one call of `fn`: the device's busy share (the
    union of its kernel and copy intervals over the call's host-clock
    span) and the kernels that took the most device time, plus the port's
    own kernels wherever they rank. A profiler that records no device
    activity leaves both unmeasured; it fails nothing. Returns the busy
    share, or None when unmeasured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profiled_span"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "profiled_span"
                and e.device_type == DeviceType.CPU)
    # annotations (this span's, the optimizer's record_function ranges)
    # also appear on the device's timeline: they are not kernels
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and e.name != "profiled_span"
                 and not getattr(e, "is_user_annotation", False))
    if not dev:
        log(f"profile of {what}: torch.profiler recorded no device "
            f"activity; busy share not measured [{card}]")
        return None
    busy, reach, per_name = 0.0, span.start, {}
    for start, end, name in dev:
        lo, hi = max(start, reach), min(end, span.end)
        if hi > lo:
            busy += hi - lo
            reach = hi
        per_name[name] = per_name.get(name, 0.0) + (end - start)
    dev_total = sum(per_name.values())
    wall = span.end - span.start
    log(f"profile of {what} (torch.profiler, CPU+CUDA): "
        f"span {wall / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall:.3f} of the span), device time summed over "
        f"{len(dev)} kernels and copies {dev_total / 1e3:.1f} ms [{card}]")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])
    for name, us in ranked[:top]:
        log(f"  {us / 1e3:9.2f} ms {us / dev_total:6.3f}  {name[:100]}")
    for name, us in ranked[top:]:   # the port's own kernels, wherever they rank
        if any(k in name for k in PORT_KERNELS):
            log(f"  {us / 1e3:9.2f} ms {us / dev_total:6.3f}  {name[:100]}")
    return busy / wall


# ---------------------------------------------------------------------------
# the training slice: train, checkpoint, evaluate, serve the checkpoint
# ---------------------------------------------------------------------------
HEAT4_CONFIG = "configs/BRCA/HEAT4_kimia_classification.yml"
TRAIN_SPLITS = (("train", 6), ("val", 3), ("test", 3))   # slides per split
TRAIN_N = (1000, 3000)     # patches per synthetic slide, drawn uniformly
TRAIN_EPOCHS = 2


def write_cohort(torch, dev, root: Path, in_dim: int, n_range, seed=0):
    """Seeded synthetic slides under TCGA barcodes: tumour slides (odd
    index) have their features shifted by +0.5, node types are uniform in
    [0, 6). Each graph is built on `dev` by build_lattice_device (one KNN
    per slide) and written by save_graph_npz; the even slides go on the
    normal list. Returns {split: list file}."""
    import numpy as np

    from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz
    from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
    from wsi_hgnn_tpu_torch.utils import to_numpy, to_torch

    rng = np.random.RandomState(seed)
    splits, normals, i = {}, [], 0
    for split, count in TRAIN_SPLITS:
        paths = []
        for _ in range(count):
            n = int(rng.randint(n_range[0], n_range[1] + 1))
            feat = (rng.randn(n, in_dim) + 0.5 * (i % 2)).astype(np.float32)
            types = rng.randint(0, N_TYPES, n).astype(np.int32)
            g = build_lattice_device(
                to_torch(feat[None], dev), to_torch(types[None], dev),
                torch.ones(1, n, dtype=torch.bool, device=dev), RADIUS,
                N_TYPES)
            barcode = f"TCGA-XX-{i:04d}-01Z-00-DX1"
            path = root / f"{barcode}.npz"
            save_graph_npz(path, feat, np.repeat(np.arange(n), RADIUS - 1),
                           to_numpy(g.idx[0]).reshape(-1), node_type=types,
                           esign=to_numpy(g.esign[0]).reshape(-1),
                           sim=to_numpy(g.sim[0]).reshape(-1))
            paths.append(str(path))
            if i % 2 == 0:
                normals.append(barcode[:16])
            i += 1
        splits[split] = root / f"{split}.txt"
        splits[split].write_text("\n".join(paths) + "\n")
    (root / "normal.txt").write_text("\n".join(normals) + "\n")
    return splits


# card vs CPU gradients of one step, per parameter tensor: the relative L2
# error ||g_card - g_cpu|| / ||g_cpu|| within GRAD_RTOL (the zoo's CPU
# parity bound against JAX). A tensor beyond it passes only where the f32
# arithmetic explains the miss, judged by the same step in float64 on the
# CPU: ||g_card - g_64|| <= GRAD_F32 ||g_cpu - g_64|| + GRAD_NOISE G_64,
# G_64 the model's largest float64 gradient norm. Gradients that cancel
# to about 0 (attention key and gate biases under a softmax, prediction
# biases summed from per-slide terms of opposite sign) and GAT's attention
# gradients carry f32 errors above 1e-4 of themselves on either device;
# one whose exact value is 0 carries rounding noise only, a few ulps of
# the gradients it was summed from.
GRAD_RTOL, GRAD_F32, GRAD_NOISE = 1e-4, 3.0, 1e-6


class float64_default:
    """Context: float64 as torch's default float type (the reference
    step's tensors created inside the step), restored on exit."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.old = self.torch.get_default_dtype()
        self.torch.set_default_dtype(self.torch.float64)

    def __exit__(self, *exc):
        self.torch.set_default_dtype(self.old)


def grad_check(torch, named_cpu, named_dev, named_f64):
    """Three models' `.grad` after the same step (the step zeroes them
    before its backward and leaves them set): on the CPU in f32, on the
    card, on the CPU in float64. Returns (one log fragment, the names of
    the tensors that fail). A CPU gradient that is exactly zero (a dead
    layer) must be exactly zero on the card."""
    rows = [(name, p32.grad.detach().double(),
             pd.grad.detach().cpu().double(), p64.grad.detach())
            for (name, p32), (_, pd), (_, p64) in zip(named_cpu, named_dev,
                                                      named_f64)]
    noise = GRAD_NOISE * max(float(g64.norm()) for *_, g64 in rows)
    rel, explained, failed = {}, {}, []
    for name, g32, gd, g64 in rows:
        den = float(g32.norm())
        if den == 0.0:
            if gd.any():
                failed.append(name)
            continue
        rel[name] = float((gd - g32).norm()) / den
        if rel[name] > GRAD_RTOL:
            bound = GRAD_F32 * float((g32 - g64).norm()) + noise
            explained[name] = float((gd - g64).norm()) / bound
            if explained[name] > 1.0:
                failed.append(name)
    w_rel = max(rel, key=rel.get)
    text = (f"gradients of {len(rel)} nonzero parameter tensors: largest "
            f"rel L2 err {rel[w_rel]:.3g} ({w_rel}); "
            f"{len(rel) - len(explained)} within {GRAD_RTOL:g}")
    if explained:
        w_ex = max(explained, key=explained.get)
        text += (f", {len(explained)} beyond it judged by the float64 step:"
                 f" largest error over its bound {explained[w_ex]:.3g} "
                 f"({w_ex}; bound {GRAD_F32:g} x the CPU f32 error + "
                 f"{GRAD_NOISE:g} of the largest gradient norm)")
    return text, failed


def step_on_card_vs_cpu(torch, dev, cfg, data, k: int, cap: int):
    """One train step from the same seeded weights, batch, augmentation and
    dropout masks, on the card, on the CPU plain path and on the CPU in
    float64: (loss relative error, and grad_check's result)."""
    import copy

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import (parse_lattice_twin, parse_loss,
                                           parse_optimizer)
    from wsi_hgnn_tpu_torch.data.lattice_loader import (LatticeLoader,
                                                        lattice_to_torch)
    from wsi_hgnn_tpu_torch.models.lattice import TrainMasks, draw_train_masks
    from wsi_hgnn_tpu_torch.train import lattice_train_step
    from wsi_hgnn_tpu_torch.utils import to_torch

    cpu = torch.device("cpu")
    g_np, labels, weights = LatticeLoader(data, 2, k, cap, shuffle=False
                                          )._make_batch([0, 1])
    gen = torch.Generator().manual_seed(7)
    model = convert.init_flax_like_(parse_lattice_twin(cfg["GNN"]), seed=5)
    g_cpu = lattice_to_torch(g_np, cpu)
    masks = draw_train_masks(g_cpu, gen)
    drops = model.draw_dropout_masks(g_cpu, gen)
    loss_fn = parse_loss(cfg["train"])
    m64 = copy.deepcopy(model).double()
    out = {}
    for device, m in ((cpu, copy.deepcopy(model)), (dev, model.to(dev))):
        loss, _ = lattice_train_step(
            m, parse_optimizer(cfg["optimizer"], m.parameters()), loss_fn,
            lattice_to_torch(g_np, device),
            to_torch(labels, device, torch.int64), to_torch(weights, device),
            masks=TrainMasks(*(t.to(device) for t in masks)),
            drop_masks=[t.to(device) for t in drops])
        out[device.type] = (float(loss), list(m.named_parameters()))
    g64 = lattice_to_torch(g_np, cpu)
    with float64_default(torch):
        lattice_train_step(
            m64, parse_optimizer(cfg["optimizer"], m64.parameters()), loss_fn,
            g64._replace(feats=g64.feats.double(), sim=g64.sim.double()),
            to_torch(labels, cpu, torch.int64),
            to_torch(weights, cpu).double(), masks=masks, drop_masks=drops)
    (l_cpu, p_cpu), (l_dev, p_dev) = out["cpu"], out[dev.type]
    return (abs(l_dev - l_cpu) / abs(l_cpu),) + grad_check(
        torch, p_cpu, p_dev, m64.named_parameters())


def train_phase(torch, dev, card, kernels, root: Path, n_range=TRAIN_N,
                gnn=None):
    """Build and write the synthetic cohort under `root`, train the
    config's HEAT4 for two epochs, evaluate the checkpoint, serve it;
    check the checkpoint contract and that trainer, evaluator, predictor
    and the CPU agree. Returns the launch counts of the cohort build,
    training and evaluation, and the cohort's split lists. `gnn`
    overrides GNN keys (a small CPU rehearsal)."""
    import math

    import numpy as np

    from wsi_hgnn_tpu_torch.config import load_config
    from wsi_hgnn_tpu_torch.data.lattice_loader import lattice_to_torch
    from wsi_hgnn_tpu_torch.serve import SlidePredictor
    from wsi_hgnn_tpu_torch.train import GNNTrainer, HomoGraphEvaluator
    from wsi_hgnn_tpu_torch.utils import to_torch

    cfg = load_config(ROOT / HEAT4_CONFIG)
    cfg["GNN"].update(gnn or {})
    cfg["train"]["num_epochs"] = TRAIN_EPOCHS
    g = cfg["GNN"]
    cfg["checkpoint"]["path"] = str(root / "checkpoint")
    # ---- the main path: counters from 0 ----------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    splits = write_cohort(torch, dev, root, int(g["in_dim"]), n_range)
    t_data = time.perf_counter() - t0
    cfg["datasets"].update(
        train_path=str(splits["train"]), valid_path=str(splits["val"]),
        eval_path=str(splits["test"]),
        normal_path=str(root / "normal.txt"))

    trainer = GNNTrainer(cfg, seed=611, device=dev)
    losses, step_ms = [], []
    step = trainer.train_step

    def timed_step(graph, labels, weights):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, prob = step(graph, labels, weights)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        return loss, prob

    trainer.train_step = timed_step
    t = time.perf_counter()
    stats = trainer.train()
    t_train = time.perf_counter() - t
    evaluator = HomoGraphEvaluator(cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = evaluator.eval()
    torch.cuda.synchronize()
    n_test = len(evaluator.test_data)
    eval_ms = (time.perf_counter() - t) * 1e3 / n_test
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # ---- checks -----------------------------------------------------
    n_steps = TRAIN_EPOCHS * -(-TRAIN_SPLITS[0][1] // 2)
    check(len(losses) == n_steps and all(map(math.isfinite, losses)),
          f"train losses {losses}: want {n_steps} finite")
    ckpt = Path(cfg["checkpoint"]["path"])
    files = sorted(p.name for p in ckpt.iterdir())
    check(files == ["configs.json", f"model_v{TRAIN_EPOCHS}.msgpack",
                    "training_stats.json", "version.txt"],
          f"checkpoint directory holds {files}")
    check((ckpt / "version.txt").read_text() == f"{TRAIN_EPOCHS}\n",
          "version.txt is not the last epoch")
    lines = (ckpt / "training_stats.json").read_text().splitlines()
    check([json.loads(x)["Epoch"] for x in lines]
          == list(range(1, TRAIN_EPOCHS + 1)),
          f"training_stats.json epochs {lines}")
    names = ("Accuracy", "F1", "Precision", "Recall", "AUC")
    want = [stats[f"Testing {m}"] for m in names]
    # the stats are rounded to 5 digits when written
    check(all(abs(a - b) <= 1e-5 for a, b in zip(got, want)),
          f"evaluator metrics {got} != the trainer's last test {want}")
    label = evaluator.last_metrics["label"]
    check(len(set(label.tolist())) == 2, "test split lacks a class")

    pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                          checkpoint_path=str(ckpt), device=dev)
    served = []
    for path in evaluator.test_data.graph_paths:
        with np.load(path) as z:
            served.append(pred.predict(z["feat"], z["node_type"]))
    err = float(np.abs(np.stack(served)
                       - evaluator.last_metrics["prob"]).max())
    log(f"train phase: SlidePredictor(checkpoint_path=) vs evaluator "
        f"probabilities on {n_test} test slides: max|err| {err:.3g} "
        f"(atol 1e-4)")
    check(err <= 1e-4, f"served checkpoint differs from the evaluator by "
          f"{err}")

    # the evaluator's forward alone, on one batch of all 3 test slides;
    # and the first two training slides as one train batch
    path, loader = evaluator.splits.loader_of(evaluator.test_data)
    check(trainer.lattice and path == "lattice",
          f"HEAT4 trained on the lattice {trainer.lattice}, evaluated on "
          f"the {path} path")
    graph = lattice_to_torch(loader._make_batch(range(n_test))[0], dev)
    fwd = evaluator.splits.fwd[path]
    fwd_ms = cuda_ms(lambda: fwd(graph), reps=10) / n_test
    g_np, labels, weights = trainer.loader._make_batch([0, 1])
    batch = (lattice_to_torch(g_np, dev), to_torch(labels, dev, torch.int64),
             to_torch(weights, dev))

    rel, text, failed = step_on_card_vs_cpu(
        torch, dev, cfg, trainer.train_data, trainer.k,
        trainer.loader.node_capacity)
    log(f"train phase: one step card vs CPU plain path: loss rel err "
        f"{rel:.3g} (<= 1e-5); {text}")
    check(rel <= 1e-5 and not failed,
          f"card train step differs from the CPU: loss {rel}; gradients of "
          f"{failed}")

    cap = trainer.loader.node_capacity
    log(f"train phase: GNN {g['name']} in {g['in_dim']} hidden "
        f"{g['hidden_dim']} heads {g['n_heads']} layers {g['num_layers']}, "
        f"batch {cfg['train']['batch_size']} x {cap} nodes, k {trainer.k}; "
        f"cohort of {sum(c for _, c in TRAIN_SPLITS)} slides built and "
        f"written in {t_data:.1f} s; {TRAIN_EPOCHS} epochs in {t_train:.1f} s;"
        f" losses {[round(x, 5) for x in losses]}; test metrics "
        f"{[round(x, 5) for x in got]}; launches {launches}")
    log(f"timing train: {float(np.median(step_ms[1:])):.2f} ms per train step"
        f" (median of steps 2..{len(step_ms)}, host clock, synchronised; "
        f"first step {step_ms[0]:.1f} ms), {eval_ms:.1f} ms per eval slide "
        f"(HomoGraphEvaluator.eval over {n_test} slides: npz load, pack, "
        f"forward; the forward alone {fwd_ms:.2f} ms per slide, CUDA events)"
        f", peak device memory of the phase {peak_gib:.2f} GiB [{card}]")
    profile_span(torch, lambda: step(*batch),
                 f"one train step (batch 2 x {cap} nodes)", card)
    return launches, splits


# ---------------------------------------------------------------------------
# the zoo: the TypedGraph models on the train phase's cohort
# ---------------------------------------------------------------------------
# (config, epochs, GNN/train overrides): the six families at the width of
# their BRCA classification config, and HEAT4 with the lattice off
ZOO = (
    ("configs/BRCA/GCN_kimia_classification.yml", 1, {}),
    ("configs/BRCA/GAT_kimia_classification.yml", 1, {}),
    ("configs/BRCA/GIN_kimia_classification.yml", 1, {}),
    ("configs/BRCA/GCN_NTPool_kimia_classification.yml", 1, {}),
    ("configs/BRCA/HetRGCN_kimia_classification.yml", 1, {}),
    ("configs/BRCA/HGT_kimia_classification.yml", 2, {}),
    ("configs/BRCA/GCN_asap_classification.yml", 1, {}),
    (HEAT4_CONFIG, 1, {"train": {"lattice": "off"}}),
)
ZOO_TIMED_STEPS = 3


def write_homogeneous(root: Path, splits):
    """The cohort again as untyped `.npz` files (self-loops added at load,
    as homogeneous models are trained and served); no new KNN. Returns
    {split: list file}."""
    import numpy as np

    from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz

    (root / "homo").mkdir(exist_ok=True)
    out = {}
    for split, listing in splits.items():
        paths = []
        for typed in Path(listing).read_text().split():
            untyped = root / "homo" / Path(typed).name
            with np.load(typed) as z:
                save_graph_npz(untyped, z["feat"], z["src"], z["dst"],
                               esign=z["esign"], sim=z["sim"],
                               is_hetero=False)
            paths.append(str(untyped))
        out[split] = root / "homo" / f"{split}.txt"
        out[split].write_text("\n".join(paths) + "\n")
    return out


def typed_step_on_card_vs_cpu(torch, dev, cfg, trainer):
    """One TypedGraph step from the same seeded weights on the first two
    train slides, the augmentation and dropout masks the CPU step drew
    replayed on the card and in a float64 CPU step: (loss relative error,
    and grad_check's result)."""
    import copy

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import (parse_gnn_model, parse_loss,
                                           parse_optimizer)
    from wsi_hgnn_tpu_torch.data.loader import GraphLoader
    from wsi_hgnn_tpu_torch.graph import transforms
    from wsi_hgnn_tpu_torch.graph.typed_graph import to_homogeneous
    from wsi_hgnn_tpu_torch.models import DropSource
    from wsi_hgnn_tpu_torch.train import typed_train_step
    from wsi_hgnn_tpu_torch.utils import to_torch

    cpu = torch.device("cpu")
    host, labels, weights = GraphLoader(trainer.train_data, 2,
                                        shuffle=False)._make_batch([0, 1])
    model, hetero = parse_gnn_model(cfg["GNN"])
    convert.init_flax_like_(model, seed=5)
    gen = torch.Generator().manual_seed(7)
    g_cpu = host.to_torch(cpu)
    masks = transforms.draw_train_masks(
        g_cpu if hetero else to_homogeneous(g_cpu), gen)
    drops = DropSource(gen)
    loss_fn = parse_loss(cfg["train"])
    m64 = copy.deepcopy(model).double()
    out = {}
    for device, m, src in ((cpu, copy.deepcopy(model), drops),
                           (dev, model.to(dev), None)):
        src = src or DropSource(masks=[t.to(device) for t in drops.used])
        loss, _ = typed_train_step(
            m, parse_optimizer(cfg["optimizer"], m.parameters()), loss_fn,
            host.to_torch(device), to_torch(labels, device, torch.int64),
            to_torch(weights, device), hetero,
            masks=transforms.TrainMasks(*(t.to(device) for t in masks)),
            drops=src)
        out[device.type] = (float(loss), list(m.named_parameters()))
    g64 = host.to_torch(cpu)
    with float64_default(torch):
        typed_train_step(
            m64, parse_optimizer(cfg["optimizer"], m64.parameters()), loss_fn,
            g64.replace(feat=g64.feat.double(), sim=g64.sim.double()),
            to_torch(labels, cpu, torch.int64),
            to_torch(weights, cpu).double(), hetero, masks=masks,
            drops=DropSource(masks=drops.used))
    (l_cpu, p_cpu), (l_dev, p_dev) = out["cpu"], out[dev.type]
    return (abs(l_dev - l_cpu) / abs(l_cpu),) + grad_check(
        torch, p_cpu, p_dev, m64.named_parameters())


def zoo_phase(torch, dev, card, kernels, root: Path, splits, widths=None):
    """Each ZOO entry on the cohort under `root`: GNNTrainer (TypedGraph
    path), HomoGraphEvaluator on the checkpoint it wrote (equal to the
    trainer's last test metrics), SlidePredictor(checkpoint_path=) on the
    test slides' features with each graph rebuilt on the device (equal to
    the evaluator's probabilities; one KNN launch per slide), and one
    step on the card against the CPU. Prints ms per train step, eval ms
    per slide and peak device memory per family, and profiles one HGT
    step. Returns the launch counts of the phase. `widths` overrides GNN
    keys of every family (a small CPU rehearsal)."""
    import math

    import numpy as np

    from wsi_hgnn_tpu_torch.config import load_config, parse_gnn_model
    from wsi_hgnn_tpu_torch.serve import SlidePredictor
    from wsi_hgnn_tpu_torch.train import GNNTrainer, HomoGraphEvaluator
    from wsi_hgnn_tpu_torch.utils import to_torch

    homo = write_homogeneous(root, splits)
    names = ("Accuracy", "F1", "Precision", "Recall", "AUC")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    served, profiled, step_failures = 0, None, []
    for i, (path, epochs, override) in enumerate(ZOO):
        cfg = load_config(ROOT / path)
        cfg["GNN"].update(widths or {})
        cfg["train"].update(override.get("train", {}), num_epochs=epochs)
        g = cfg["GNN"]
        tag = g["name"] + (" (lattice off)" if override else "") + (
            " (asap)" if g.get("graph_pooling_type") == "asap" else "")
        lists = splits if parse_gnn_model(g)[1] else homo
        cfg["checkpoint"]["path"] = str(root / f"zoo_{i}")
        cfg["datasets"].update(
            train_path=str(lists["train"]), valid_path=str(lists["val"]),
            eval_path=str(lists["test"]), normal_path=str(root / "normal.txt"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = GNNTrainer(cfg, seed=611, device=dev)
        check(not trainer.lattice, f"{tag} trained on the lattice")
        losses, step_ms = [], []
        step = trainer.train_step

        def timed_step(graph, labels, weights):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, prob = step(graph, labels, weights)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            return loss, prob

        trainer.train_step = timed_step
        stats = trainer.train()
        t_train = time.perf_counter() - t0
        trained = list(losses)
        evaluator = HomoGraphEvaluator(cfg, verbose=False, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = evaluator.eval()
        torch.cuda.synchronize()
        n_test = len(evaluator.test_data)
        eval_ms = (time.perf_counter() - t) * 1e3 / n_test

        n_steps = epochs * -(-len(trainer.train_data) //
                             int(cfg["train"]["batch_size"]))
        check(len(trained) == n_steps and all(map(math.isfinite, trained)),
              f"{tag} train losses {trained}: want {n_steps} finite")
        want = [stats[f"Testing {m}"] for m in names]
        check(all(abs(a - b) <= 1e-5 for a, b in zip(got, want)),
              f"{tag} evaluator metrics {got} != the trainer's last test "
              f"{want}")
        check(evaluator.splits.loader_of(evaluator.test_data)[0] == "typed",
              f"{tag} not evaluated on the TypedGraph path")

        pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                              checkpoint_path=cfg["checkpoint"]["path"],
                              device=dev)
        knn0 = kernels.launch_counts()["knn_l2_fused"]
        probs = []
        for p in evaluator.test_data.graph_paths:
            with np.load(p) as z:
                probs.append(pred.predict(z["feat"], z["node_type"]))
        knn = kernels.launch_counts()["knn_l2_fused"] - knn0
        served += n_test
        err = float(np.abs(np.stack(probs)
                           - evaluator.last_metrics["prob"]).max())
        check(err <= 1e-4, f"{tag} served probabilities differ from the "
              f"evaluator by {err}")
        check(knn == n_test, f"{tag}: {knn} KNN launches for {n_test} "
              f"served slides")

        # steady state: more steps on the first train batch
        g_b, labels, weights = next(iter(trainer.loader))
        batch = (g_b, to_torch(labels, dev, torch.int64),
                 to_torch(weights, dev))
        for _ in range(ZOO_TIMED_STEPS):
            timed_step(*batch)
        ms = float(np.median(step_ms[-ZOO_TIMED_STEPS:]))
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        rel, text, failed = typed_step_on_card_vs_cpu(torch, dev, cfg,
                                                      trainer)
        if rel > 1e-5 or failed:
            step_failures.append(f"{tag}: loss {rel}, gradients of {failed}")
        widths_of = ", ".join(f"{k} {g[k]}" for k in (
            "in_dim", "hidden_dim", "num_heads", "n_heads", "num_layers")
            if k in g)
        log(f"zoo {tag} ({path}: {widths_of}, batch "
            f"{cfg['train']['batch_size']}, {epochs} epoch(s) in "
            f"{t_train:.1f} s): losses {[round(x, 5) for x in trained]}, test "
            f"metrics {[round(x, 5) for x in got]}; served vs evaluator "
            f"max|err| {err:.3g} (atol 1e-4), {knn} KNN launches for {n_test}"
            f" slides; card vs CPU step loss rel err {rel:.3g} (<= 1e-5), "
            f"{text}")
        log(f"timing zoo {tag}: {ms:.2f} ms per train step (median of "
            f"{ZOO_TIMED_STEPS} steps on one batch after {len(trained)} "
            f"training steps; first step {step_ms[0]:.1f} ms; host clock, "
            f"synchronised), {eval_ms:.1f} ms per eval slide "
            f"(HomoGraphEvaluator.eval over {n_test} slides), peak device "
            f"memory {peak_gib:.2f} GiB [{card}]")
        if g["name"] == "HGT":
            profiled = (lambda s=step, b=batch: s(*b), g_b.num_nodes)
        # the next family's peak counts none of this one's tensors
        del trainer, evaluator, pred, batch, g_b, step
    # every family's step is compared before one failure ends the phase
    check(not step_failures, "card train steps differ from the CPU: "
          + "; ".join(step_failures))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check(launches["knn_l2_fused"] == served and not any(
        v for k, v in launches.items() if k != "knn_l2_fused"),
        f"zoo phase launched {launches}, want {served} KNN launches only")
    fn, n_nodes = profiled
    profile_span(torch, fn, f"one HGT train step (batch 1, {n_nodes} node "
                 f"slots)", card)
    return launches


# ---------------------------------------------------------------------------
# construction: patch files -> graphs on the card, reference-layout weights
# ---------------------------------------------------------------------------
CONSTRUCT_CONFIG = "configs/GraphConstruction/BRCA_HovernetKimia_graph_constructor.yml"
CONSTRUCT_SLIDES = (300, 600, 1000)          # patches per synthetic slide


KNN_TIE_ULPS = 64   # f32 rounding window of a 1024-term distance, in ulps


def graph_vs_cpu(np, feat, src, dst, sim, het):
    """A slide's card graph (src, dst, sim as written) against `het`,
    built from the same features on the CPU: (rows compared or None,
    description of the rows whose neighbour lists differ, sim max|err|
    over the edges both hold). Lists may differ only where every
    swapped neighbour's float64 distance lies within KNN_TIE_ULPS f32
    ulps of (|q|^2 + |c|^2) of the row's k-th distance."""
    e = int(np.asarray(het.edge_mask).sum())
    c_src, c_dst = np.asarray(het.src)[:e], np.asarray(het.dst)[:e]
    c_sim = np.asarray(het.sim)[:e]
    f = feat.astype(np.float64)
    sq = (f * f).sum(1)
    differ, worst, sim_err = 0, 0.0, 0.0
    for i in np.unique(np.concatenate([src, c_src])):
        mine, theirs = dst[src == i], c_dst[c_src == i]
        common = np.intersect1d(mine, theirs)
        if len(common):
            a = dict(zip(mine, sim[src == i]))
            b = dict(zip(theirs, c_sim[c_src == i]))
            sim_err = max(sim_err, max(abs(a[j] - b[j]) for j in common))
        if np.array_equal(mine, theirs):
            continue
        differ += 1
        both = np.union1d(mine, theirs)
        d2 = sq[i] + sq[both] - 2.0 * f[both] @ f[i]
        kth = max(d2[np.isin(both, mine)].max(), d2[np.isin(both, theirs)].max())
        swapped = np.setxor1d(mine, theirs)
        tol = KNN_TIE_ULPS * 2.0 ** -24 * (sq[i] + sq[swapped])
        far = np.abs(d2[np.isin(both, swapped)] - kth) / tol
        worst = max(worst, float(far.max()) if len(far) else 0.0)
    rows = len(np.unique(src))
    text = (f"{differ} of {rows} rows' neighbour lists differ, swapped "
            f"neighbours within {worst:.3g} of the {KNN_TIE_ULPS}-ulp tie "
            f"window")
    return (rows if worst <= 1.0 else None), text, sim_err


def write_patch_slides(root: Path, sizes, seed: int = 40):
    """Seeded 256x256 JPEG patches (8x8 blocks of 32x32 colour) in the
    patch_path/<class>/<slide>/ layout; slide 0 is a normal, the others
    tumours. Returns (patch_path, slide names)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    names = []
    for i, n in enumerate(sizes):
        names.append(f"TCGA-XX-{9000 + i}-{'11A' if i == 0 else '01Z'}-00-DX1")
        d = root / "patches" / ("normal" if i == 0 else "tumor") / names[-1]
        d.mkdir(parents=True)
        for j in range(n):
            low = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
            Image.fromarray(np.kron(low, np.ones((32, 32, 1), np.uint8))
                            ).save(d / f"{j:04d}_0.jpeg", quality=90)
    return str(root / "patches") + "/", names


def write_reference_weights(torch, root: Path):
    """Seeded KimiaNet and HoVer-Net weights written with torch.save under
    the reference's key names (a positional KimiaNet .pth, a HoVer-Net
    .tar with its 'desc' dict). Returns (kimia path, hover path, kimia
    variables, hover variables), the variables in flax layout."""
    from wsi_hgnn_tpu_torch import convert as bridge
    from wsi_hgnn_tpu_torch.models.featurizers import (HoVerNet, KimiaNet,
                                                       convert)

    kimia = bridge.to_flax_variables(bridge.init_flax_like_(KimiaNet(), 11))
    hover = bridge.to_flax_variables(bridge.init_flax_like_(
        HoVerNet.typing(N_TYPES, "fast"), 12))
    kpath, hpath = root / "KimiaNetPyTorchWeights.pth", root / "hovernet.tar"
    torch.save({k: torch.from_numpy(v) for k, v in
                convert.kimianet_state_dict(kimia).items()}, kpath)
    torch.save({"desc": {k: torch.from_numpy(v) for k, v in
                         convert.hovernet_state_dict(hover).items()}}, hpath)
    return str(kpath), str(hpath), kimia, hover


def construct_phase(torch, dev, card, kernels, root: Path,
                    sizes=CONSTRUCT_SLIDES, gnn=None):
    """configs/GraphConstruction/BRCA_HovernetKimia_graph_constructor.yml
    with its paths redirected under `root`: construct_all on the card over
    seeded JPEG slides, KimiaNet and HoVer-Net from reference-layout
    files, then generate_splits; the features of one slide held against
    the encoder given the same weights as flax variables, its graph
    against the CPU plain path, and a GNNTrainer epoch on the written
    files. Counters are zeroed before construct_all and read after it.
    Returns those launch counts. `gnn` overrides the trainer's GNN keys
    (a small CPU rehearsal)."""
    import math

    import numpy as np

    from wsi_hgnn_tpu_torch.config import load_config
    from wsi_hgnn_tpu_torch.graph.build import build_graph
    from wsi_hgnn_tpu_torch.models.featurizers import make_cnn_encoder
    from wsi_hgnn_tpu_torch.pipeline import (construct_all, generate_splits,
                                             iter_patch_batches, list_patches)
    from wsi_hgnn_tpu_torch.profiling import GLOBAL_TIMER
    from wsi_hgnn_tpu_torch.train import GNNTrainer

    t0 = time.perf_counter()
    patch_path, names = write_patch_slides(root, sizes)
    kpath, hpath, kimia, hover = write_reference_weights(torch, root)
    cfg = load_config(ROOT / CONSTRUCT_CONFIG)
    gcfg, hcfg, kcfg = (cfg["graph_constructor"], cfg["hovernet_config"],
                        cfg["kimianet_config"])
    gcfg.update(patch_path=patch_path, out_dir=str(root / "graphs"))
    hcfg["hovernet_model_path"], kcfg["kimianet_model_path"] = hpath, kpath
    check(gcfg["encoder_name"] == "kimia" and gcfg["knn_impl"] == "pallas"
          and gcfg["radius"] == RADIUS and gcfg["node_type_dir"] is None
          and hcfg["batch_size"] == CHUNK,
          f"construction config is not the one this phase states: {gcfg}")
    t_setup = time.perf_counter() - t0
    # ---- the main path: counters from 0 ---------------------------------
    for table in (GLOBAL_TIMER.totals, GLOBAL_TIMER.counts):
        table.clear()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    written = construct_all(gcfg, hcfg, kcfg, device=dev)
    t_construct = time.perf_counter() - t0
    launches = kernels.launch_counts()
    stages = {k: v for k, v in GLOBAL_TIMER.totals.items()
              if k.startswith("construct/")}
    check(written == len(sizes), f"construct_all wrote {written} of "
          f"{len(sizes)} slides")
    chunks = sum(-(-n // CHUNK) for n in sizes)
    want = {"knn_l2_fused": len(sizes),
            **{k: v * chunks for k, v in PER_CHUNK.items()}}
    check(launches == want, f"construction launched {launches}, want {want}")

    out = Path(gcfg["out_dir"])
    labels = root / "typing_labels.txt"
    labels.write_text("".join(
        f"{name[:12]}\tInfiltrating {'Ductal' if i % 2 else 'Lobular'} "
        f"Carcinoma\n" for i, name in enumerate(names)))
    (root / "no_normals.txt").write_text("\n")
    lists = Path(generate_splits(gcfg, normal_path=str(root / "no_normals.txt"),
                                 label_path=str(labels)))
    listed = sorted(Path(p).stem for split in ("train", "val", "test")
                    for p in (lists / f"heterogeneous_{split}.txt")
                    .read_text().split())
    check(listed == sorted(names), f"splits list {listed}, want {names}")

    # slide 0: features against the encoder given the same weights as flax
    # variables (the same kernels and bf16 storage)
    with np.load(out / "heterogeneous" / f"{names[0]}.npz") as z:
        feat, src, dst, sim = z["feat"], z["src"], z["dst"], z["sim"]
    types = np.load(out / "node_types" / f"{names[0]}.npy")
    enc = make_cnn_encoder("kimia", {"feature_dim": 1024,
                                     "n_node_type": N_TYPES}, hcfg, kcfg,
                           with_typing=True, pad_batch_to=CHUNK, device=dev,
                           kimia_variables=kimia, hover_variables=hover)
    paths = list_patches(Path(patch_path) / "normal" / names[0])
    got = [enc(b) for b in iter_patch_batches(paths, CHUNK,
                                              out_dtype="uint8")]
    f2 = np.concatenate([g[0] for g in got])
    t2 = np.concatenate([g[1] for g in got])
    rel = float((np.linalg.norm(f2 - feat, axis=1)
                 / np.linalg.norm(feat, axis=1)).max())
    check(rel <= 1e-4 and np.array_equal(t2, types),
          f"features from the weight files differ from the flax-variable "
          f"encoder's by {rel} relative (types equal: "
          f"{np.array_equal(t2, types)})")
    # its graph against the CPU plain path on the written features: the
    # same neighbour lists and sims, except in rows where neighbours tie
    # within f32 rounding of |q|^2 + |c|^2 - 2 q.c (both devices compute
    # it in f32 in their own summation order)
    het, _ = build_graph(feat, types, RADIUS, N_TYPES, knn_impl="pallas",
                         device="cpu")
    graph_rows, ties, sim_err = graph_vs_cpu(np, feat, src, dst, sim, het)
    check(graph_rows is not None and sim_err <= 1e-5,
          f"card graph of {names[0]} differs from the CPU's beyond f32 "
          f"ties: {ties}; sim max|err| {sim_err}")

    # the trainer reads the written files
    tcfg = load_config(ROOT / HEAT4_CONFIG)
    tcfg["GNN"].update(gnn or {})
    listing = root / "constructed.txt"
    listing.write_text("".join(f"{out / 'heterogeneous' / n}.npz\n"
                               for n in names))
    (root / "constructed_normal.txt").write_text(names[0][:16] + "\n")
    tcfg["datasets"].update(
        train_path=str(listing), valid_path=str(listing),
        eval_path=str(listing),
        normal_path=str(root / "constructed_normal.txt"))
    tcfg["train"]["num_epochs"] = 1
    tcfg["checkpoint"]["path"] = str(root / "constructed_ckpt")
    stats = GNNTrainer(tcfg, seed=611, device=dev).train()
    check(math.isfinite(stats["Train Loss: "]) and stats["Epoch"] == 1,
          f"trainer on the constructed graphs: {stats}")

    n_slides = len(sizes)
    per = {k.split("/", 1)[1]: v / n_slides * 1e3 for k, v in stages.items()}
    log(f"construct: {n_slides} slides of {list(sizes)} JPEG patches "
        f"({CONSTRUCT_CONFIG}: kimia + inline HoVer-Net typing, radius "
        f"{RADIUS}, knn_impl pallas, chunk {CHUNK}; weights from "
        f"reference-layout files), written in {t_construct:.2f} s (set-up "
        f"{t_setup:.1f} s); features vs the flax-variable encoder max rel "
        f"L2 {rel:.3g} (<= 1e-4), types equal; graph of {names[0]} vs the "
        f"CPU: {ties}, sim max|err| {sim_err:.3g} (<= 1e-5); "
        f"splits list all {n_slides}; trainer epoch loss "
        f"{stats['Train Loss: ']:.5f}; launches {launches} [{card}]")
    log(f"timing construct per slide (host clock; mean of {n_slides} "
        f"slides, {sum(sizes) / n_slides:.0f} patches): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(per.items()))
        + f"; {t_construct / n_slides * 1e3:.1f} ms per slide in all "
        f"(decode runs on a prefetch thread, overlapped) [{card}]")
    return launches


TILE_SLIDE = (8192, 6144)   # px: 32 x 24 tiles of 256
TILE_CONFIGS = ("configs/GraphConstruction/COAD_Hovernet_graph_constructor.yml",
                "configs/GraphConstruction/BRCA_HovernetEfficient_graph_constructor.yml")
TILE_CHECK = 2              # patches of the card-vs-CPU checks


def write_tissue_slide(path: Path, seed: int = 70):
    """A seeded slide image: white background with three overlapping
    elliptical 'tissue' regions of 8x8-pixel colour blocks."""
    import numpy as np
    from PIL import Image

    w, h = TILE_SLIDE
    rng = np.random.RandomState(seed)
    img = np.kron(rng.randint(40, 230, (h // 8, w // 8, 3)).astype(np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    yy, xx = np.mgrid[0:h, 0:w]
    tissue = np.zeros((h, w), bool)
    for cx, cy, rx, ry in ((0.33, 0.47, 0.34, 0.44), (0.69, 0.53, 0.31, 0.42),
                           (0.50, 0.22, 0.24, 0.18)):
        tissue |= (((xx - cx * w) / (rx * w)) ** 2
                   + ((yy - cy * h) / (ry * h)) ** 2) < 1
    img[~tissue] = 255
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path, quality=90)


def rel_l2_max(np, got, want):
    return float((np.linalg.norm(got - want, axis=1)
                  / np.linalg.norm(want, axis=1)).max())


def tile_build_phase(torch, dev, card, kernels, root: Path):
    """Slide image -> tiles -> graphs: a seeded 8192x6144 slide tiled by
    `python -m wsi_hgnn_tpu_torch.get_patches` at one magnification (PIL
    backend, 8 spawned workers), then construct_all on the card over its
    tiles with COAD_Hovernet_graph_constructor.yml ('hover': HoVer-Net
    with fc1 at 1024, seeded on the card) and with
    BRCA_HovernetEfficient_graph_constructor.yml (EfficientNet-B4 and
    inline HoVer-Net typing from seeded weight files), each config's
    chunk size and knn_impl, only the paths redirected. Per config: ms
    per slide by stage, ms per patch in the encoder, peak device memory,
    the device busy share (a second construction, profiled, its encoder
    built outside the profiled span) and the KNN
    kernel's launches (counters zeroed just before, read just after; at
    least 1). Then each CNN on the card against the CPU on TILE_CHECK
    patches in f32 (relative L2 1e-3, 'hover' types equal), and the
    written bf16 features against the CPU's f32 (relative L2 0.1).
    Returns the launch counts of the two constructions."""
    import os

    import numpy as np

    from wsi_hgnn_tpu_torch import convert as bridge
    from wsi_hgnn_tpu_torch import get_patches
    from wsi_hgnn_tpu_torch.config import load_config
    from wsi_hgnn_tpu_torch.models.featurizers import (
        EfficientNet, HoVerNet, convert, efficientnet_apply,
        hovernet_full_apply, load_cnn_variables, make_hovernet)
    from wsi_hgnn_tpu_torch.pipeline import (build_default_encoder,
                                             construct_all,
                                             iter_patch_batches, list_patches)
    from wsi_hgnn_tpu_torch.profiling import GLOBAL_TIMER
    from wsi_hgnn_tpu_torch.utils import set_cuda_numerics

    slide = "TCGA-SY-0001-01Z-00-DX1"
    write_tissue_slide(root / "data" / "SYN" / "tumor" / f"{slide}.jpeg")
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out_base = get_patches.main(["-d", "SYN", "-v", "jpeg", "-b", "40",
                                     "-o", "40", "-j", "8", "-m", "0"])
    finally:
        os.chdir(cwd)
    t_tile = time.perf_counter() - t0
    bag = root / out_base / "tumor" / slide
    paths = list_patches(bag)
    n_tiles = (TILE_SLIDE[0] // 256) * (TILE_SLIDE[1] // 256)
    check(0 < len(paths) < n_tiles, f"tiling kept {len(paths)} of "
          f"{n_tiles} tiles")
    log(f"tile_build: {TILE_SLIDE[0]}x{TILE_SLIDE[1]} seeded slide tiled by "
        f"get_patches (1 magnification, PIL backend, 8 spawned workers): "
        f"{len(paths)} of {n_tiles} tiles kept in {t_tile:.2f} s")
    check_px = next(iter_patch_batches(paths[:TILE_CHECK], TILE_CHECK,
                                       out_dtype="uint8"))

    # a seeded weight file of the HoVer-Net typing net, under the
    # reference's names, for the EfficientNet config
    hover_t = bridge.to_flax_variables(bridge.init_flax_like_(
        HoVerNet.typing(N_TYPES, "fast"), 31))
    torch.save({"desc": {k: torch.from_numpy(v) for k, v in
                         convert.hovernet_state_dict(hover_t).items()}},
               root / "hovernet_typing.tar")

    total = {}
    for cfg_path in TILE_CONFIGS:
        cfg = load_config(ROOT / cfg_path)
        gcfg, hcfg, kcfg = (cfg["graph_constructor"], cfg["hovernet_config"],
                            cfg["kimianet_config"])
        name = gcfg["encoder_name"]
        gcfg.update(patch_path=str(root / out_base) + "/",
                    out_dir=str(root / f"graphs_{name}"))
        feat_dim = int(gcfg["feature_dim"])
        if name == "hover":
            hcfg["hovernet_model_path"] = str(root / "absent.tar")
        else:
            # EfficientNet-B4 with its feat_dim-way fc, seeded, under
            # efficientnet_pytorch's names
            eff_tree = bridge.to_flax_variables(bridge.init_flax_like_(
                EfficientNet.from_name(name, feat_dim), 32))
            torch.save({k: torch.from_numpy(v) for k, v in
                        convert.efficientnet_state_dict(eff_tree).items()},
                       root / "efficientnet-b4.pth")
            del eff_tree
            hcfg["hovernet_model_path"] = str(root / "hovernet_typing.tar")
            gcfg["efficientnet_model_path"] = str(root / "efficientnet-b4.pth")
        check(name in ("hover", "efficientnet-b4")
              and gcfg["knn_impl"] == "pallas" and gcfg["radius"] == RADIUS
              and gcfg["feature_dim"] == 1024 and hcfg["batch_size"] == CHUNK,
              f"{cfg_path} is not the config this phase states: {gcfg}")
        # ---- the main path: counters from 0 -----------------------------
        for table in (GLOBAL_TIMER.totals, GLOBAL_TIMER.counts):
            table.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        written = construct_all(gcfg, hcfg, kcfg, device=dev, verbose=False)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stages = {k.split("/", 1)[1]: v * 1e3 for k, v in
                  GLOBAL_TIMER.totals.items() if k.startswith("construct/")}
        check(written == 1, f"{name}: construct_all wrote {written} slides")
        check(launches["knn_l2_fused"] >= 1, f"{name}: the KNN kernel was "
              f"not launched ({launches})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        with np.load(Path(gcfg["out_dir"]) / "heterogeneous"
                     / f"{slide}.npz") as z:
            feat, n_edges = z["feat"], len(z["src"])
        types = np.load(Path(gcfg["out_dir"]) / "node_types" / f"{slide}.npy")
        check(feat.shape == (len(paths), feat_dim) and np.isfinite(feat).all()
              and n_edges == len(paths) * (RADIUS - 1),
              f"{name}: graph of {feat.shape} features, {n_edges} edges")
        # the busy share: the same construction again, its encoder built
        # before the profiled span
        enc = build_default_encoder(gcfg, hcfg, kcfg, dev)
        for table in (GLOBAL_TIMER.totals, GLOBAL_TIMER.counts):
            table.clear()
        t0 = time.perf_counter()
        busy = profile_span(
            torch, lambda: construct_all(
                dict(gcfg, out_dir=str(root / f"profiled_{name}")), hcfg,
                kcfg, encoder=enc, device=dev, verbose=False),
            f"construct_all ({name}, {len(paths)} patches, encoder built)",
            card, top=6)
        t_warm = time.perf_counter() - t0
        warm_ms = GLOBAL_TIMER.totals.get("construct/featurize/encode", 0.0
                                          ) * 1e3 / len(paths)
        del enc

        # ---- card against CPU, f32, on TILE_CHECK patches ---------------
        set_cuda_numerics()
        x = torch.from_numpy(check_px).float() / 255.0
        with torch.inference_mode():
            if name == "hover":
                model = make_hovernet(hcfg, N_TYPES, dev, feat_dim=feat_dim)
                f_card, t_card = (a.cpu().numpy() for a in
                                  hovernet_full_apply(model, x.to(dev)))
                model = model.cpu()   # the same weights, fc1 included
                f_cpu, t_cpu = (a.numpy() for a in
                                hovernet_full_apply(model, x))
                types_ok = np.array_equal(t_card, t_cpu)
            else:
                model = EfficientNet.from_name(name, feat_dim)
                bridge.load_flax_variables(model, load_cnn_variables(
                    "efficientnet", model, gcfg["efficientnet_model_path"],
                    0)).eval()
                f_cpu = efficientnet_apply(model, x).numpy()
                f_card = efficientnet_apply(model.to(dev), x.to(dev)
                                            ).cpu().numpy()
                types_ok = True
        del model
        torch.cuda.empty_cache()
        rel = rel_l2_max(np, f_card, f_cpu)
        rel_bf16 = rel_l2_max(np, feat[:TILE_CHECK], f_cpu)
        check(rel <= 1e-3 and types_ok, f"{name}: card f32 vs CPU relative "
              f"L2 {rel} (types equal: {types_ok})")
        check(rel_bf16 <= 0.1, f"{name}: written bf16 features vs CPU f32 "
              f"relative L2 {rel_bf16}")
        typing = ("types equal" if name == "hover" else
                  f"{int((types > 0).sum())} of {len(types)} patches typed "
                  f"nonzero")
        enc_ms = stages.get("featurize/encode", 0.0) / len(paths)
        log(f"tile_build {name} ({cfg_path}; chunk {CHUNK}, knn_impl "
            f"pallas, radius {RADIUS}): 1 slide of {len(paths)} patches in "
            f"{t_build * 1e3:.1f} ms; card f32 vs CPU max rel L2 {rel:.3g} "
            f"(<= 1e-3), {typing}; written bf16 vs CPU f32 {rel_bf16:.3g} "
            f"(<= 0.1); launches {launches} [{card}]")
        log(f"timing tile_build {name} per slide (host clock): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(stages.items()))
            + f"; encoder {enc_ms:.3f} ms per patch; peak device memory "
            f"{peak:.2f} GiB. Again with the encoder built (profiled): "
            f"{t_warm * 1e3:.1f} ms, encoder {warm_ms:.3f} ms per patch, "
            "device busy share "
            + ("not measured" if busy is None else f"{busy:.3f}")
            + f" [{card}]")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v for every kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "wsi_hgnn_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: wsi_hgnn_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wsi_hgnn_tpu_torch import kernels
    from wsi_hgnn_tpu_torch.kernels import _build
    from wsi_hgnn_tpu_torch.kernels import densenet as dn
    from wsi_hgnn_tpu_torch.kernels import knn as kn
    from wsi_hgnn_tpu_torch.ops import knn as knn_ops
    from wsi_hgnn_tpu_torch.utils import set_cuda_numerics

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=args.ptxas)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(_build.SOURCES)})")
    for name, text in logs.items():
        if text.strip():
            log(f"--- nvcc {name} ---\n{text.strip()}")
    for name in ("dense_layer", "transition"):
        blocks, smem = dn.bf16_occupancy(name)
        log(f"{name} bf16 kernel: {blocks} block(s) of 256 threads per SM, "
            f"{smem} bytes of shared memory per block [{card}]")
    set_cuda_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    gen_dev = torch.Generator(device=dev).manual_seed(0)

    results = {}
    results["knn_l2_fused"] = knn_phase(torch, kn, knn_ops, dev, gen, card)
    results["dense_layer_fused"] = dense_phase(torch, dn, dev, gen_dev, card)
    results["transition_fused"] = transition_phase(torch, dn, dev, gen_dev,
                                                   card)
    for name, r in results.items():
        log(f"timing {name}: {r['ms']:.4g} ms/launch (bound {r['bound_ms']:.4g}"
            f" ms by {r['bound_by']}; plain {r['plain_ms']:.4g} ms) "
            f"[{card}]")

    # three independent groups of phases: a failed check ends its group,
    # is reported, and the run goes on to the next group; any failure
    # fails the run (exit 1, no result lines)
    failures, counts = [], []

    def serving(root):
        served, pred = slice_phase(torch, dev, card, kernels, root)
        return served, server_phase(torch, dev, card, kernels, pred)

    def training(root):
        trained, splits = train_phase(torch, dev, card, kernels, root)
        return trained, zoo_phase(torch, dev, card, kernels, root, splits)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, group in (
                ("serving", serving),
                ("construction", lambda r: (
                    construct_phase(torch, dev, card, kernels, r),
                    tile_build_phase(torch, dev, card, kernels, r))),
                ("training", training)):
            root = Path(tmp) / name
            root.mkdir()
            try:
                counts += group(root)
            except CheckFailed as e:
                failures.append(f"{name}: {e}")
                log(f"chip_smoke: {name} phases FAILED: {e}")
    if failures:
        raise CheckFailed("; ".join(failures))
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}

    # library_ms is null: no single PyTorch call computes any of the three
    # functions (a top-k KNN, or a fused affine + GEMM + conv / pool chain)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name], "library_ms": None}
        for name, src, rep in KERNELS]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
