#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`wsi_hgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, one card, exit 0 when all holds
    python3 chip_smoke.py --f32-timing   # only the f32 kernels at B = 128,
                                         # the f32 backbone, mma.sync's rates

1. Prints the card (`nvidia-smi` name and power limit) and builds every
   CUDA kernel from `wsi_hgnn_tpu_torch/csrc` with nvcc for sm_90a, one
   nvcc per source, all at once; prints the DenseNet kernels' blocks per
   SM and shared memory, bf16 and f32 (`--ptxas` adds nvcc's register
   report).
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
4. Timing lines (one line per main-path shape: each KNN size, each
   dense block, each transition, with ms/launch, bound and share of the
   bound; host clock per stage), and a torch.profiler pass over the last
   request: the device's busy share and the kernels that took the most
   device time. Kernel times are card-bound (`cuda_ms`): a
   torch.cuda._sleep holds the card while the host issues the timed
   calls, so the CUDA events bound only the card's work, and
   start.query() says whether the host was late (then the batch is
   timed again); each line also prints the same launches timed by events
   around host-issued calls (`issued_ms`, the method before), and one
   line counts the held batches and the late ones.
5. The training slice at the same width, read from that config file:
   12 seeded synthetic slides of 800-1600 patches whose graphs are
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
   variables, its graph against the CPU plain path, the same config set
   to `knn_impl: approx` over that slide (one KNN launch, every array
   written equal to the pallas build's), the public helpers on the card
   (`build_edges_device` and `knn_edges` at N = 2048 against the CPU
   plain versions, `make_hover_typing`, `profiling.trace` around one KNN
   in `annotate`: the trace holds the kernel), a `GNNTrainer` epoch on
   the written files; seconds per slide by stage.
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
10. Explanation (explain, after 9.): tile_build's slide and its 'hover'
   graph laid out as a Camelyon16 test set (reference.csv, an annotation
   XML tracing a tissue ellipse, the slide image as the thumbnail),
   `python -m wsi_hgnn_tpu_torch.main -mode graph_explain` in process on
   the card with configs/BRCA/HEAT4_kimia_classification.yml
   (HetGemExplainer) from a seeded version-1 checkpoint: the pixel AUC,
   the heatmaps written; then a 10 x 10-tile window of the slide as a
   second layout, explained on the card and on the CPU: the scores to
   1e-4, the AUCs equal; ms per slide for HetGEM, GEM on GCN and a
   100-step GNNExplainer on a seeded 1024-node slide.
11. MIL (mil, after 6.): `python -m wsi_hgnn_tpu_torch.train_mil` in
   process on the training cohort's 12 slides as bags, 2 folds x 2
   epochs of abmil, dsmil with ReMix 'cov' and gtn (its fold pickles
   kept); one step of each on the card against the CPU; ms per step and
   peak memory per model.
12. The rest of the MIL baselines (mil_tree, after 11.): `train_mil
   --model h2mil` on the cohort's bags (synthetic parent level) and
   `--nested-bags --encoder kimia` on 8 seeded two-magnification nested
   bags (58 + 3 kernel launches per encoder chunk, one slide's level-2
   features equal to the encoder called directly); `tools.vis_graphcam`
   on the gtn fold and the largest bag (card against CPU within the
   float64-measured rounding); `tools.pretrain_simclr` (frozen KimiaNet
   through the f32 kernels at B = 128, 2 epochs), `--extract` over 6
   slide directories (features equal to the KimiaNet module in f32) and
   `train_mil --model gtn` on them; one H2MIL and one SimCLR step on the
   card against the CPU; ms per H2MIL step, per GraphCAM class and per
   SimCLR step, and the f32 kernels' ms per launch at B = 128 against
   two bounds: the f32 peak outside the tensor cores and 3xTF32.
13. Several devices (parallel, a fourth group): the 'kimia' (with
   HoVer-Net typing) and 'hover' encoders sharded over a device list that
   repeats the card, on a 130-patch chunk (padded to 256, 128 a device),
   against the single-device encoder, and the slide graph of the sharded
   features; a gloo world of 2 spawned ranks on the card: the
   edge-sharded HEAT4 and GCN steps (each rank half of two 1024-node
   slides' edge store) and the data-parallel GCN step (a slide a rank),
   every gradient against the single-card step (judged by float64 where
   1e-4 misses); an NCCL world of 1: the edge-sharded step against the
   plain one.
The zoo (6.) also trains, evaluates and serves GCN with ASAP pooling
(configs/BRCA/GCN_asap_classification.yml). The card-vs-CPU steps compare
every parameter's gradient; a miss passes only where float64 explains it
(wsi_hgnn_tpu_torch/train/gradcheck.py: the card's float64 step equal to
the CPU's, the card's f32 within the f32 rounding that randomly rounded
float64 steps show). Counters are zeroed before each phase's main path
and read after it.

The line before the last is the kernels JSON (launches summed over the
served requests, the server traffic, the training slice, the zoo's
served slides, the constructions (the approx one too), the explanation, the MIL runs, the
nested bags' encoder, SimCLR's pretraining and extraction, and the
sharded encoders and the rank steps' graphs), the last
line the device JSON. Any
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

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s.
# "tf32x3": f32-accurate products as three TF32 tensor-core products
# (hi*hi + hi*lo + lo*hi), a third of the 495 TF/s TF32 peak: the least
# time the card can take for the f32 kernels' full-f32 products.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}


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


def issued_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around `reps` calls as the host
    issues them. Where a call's card work is shorter than its issue on the
    host, the host's pace is what this reads. Whole steps (which may
    synchronise inside) are timed so; the kernels' lines print it beside
    cuda_ms for comparison."""
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


# host issue time queued behind one sleep: a few hundred launches at the
# 5-10 us a launch costs the host, far below the launch queue's depth, so
# issuing never blocks on a full queue while the card sleeps
HOLD_ISSUE_MS = 2.0
HOLD_MAX_MS = 400.0
HOLD = {"timings": 0, "batches": 0, "late": []}


def sleep_cycles_per_ms(torch) -> float:
    """torch.cuda._sleep's clock ticks per ms on this card, measured once."""
    if "per_ms" not in HOLD:
        torch.cuda._sleep(1 << 20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 26)
        end.record()
        torch.cuda.synchronize()
        HOLD["per_ms"] = (1 << 26) / start.elapsed_time(end)
    return HOLD["per_ms"]


def cuda_ms(fn, reps: int, warmup: int = 2, what: str = "") -> float:
    """Mean ms per call of `fn`'s card work, from CUDA events that bound
    only the card's work: a torch.cuda._sleep holds the card while the
    host issues a batch of calls behind it, so the start event runs when
    the whole batch is already queued. start.query(), read once the last
    call is issued, says whether that held: True means the sleep ended
    first (the host was late), and the batch is logged and timed again
    behind a sleep four times longer. A batch holds at most HOLD_ISSUE_MS
    of host issue time (one call at least). `fn` must not synchronise."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_ms = sleep_cycles_per_ms(torch)
    # one call's issue time on the host, with the card held meanwhile
    torch.cuda._sleep(int(50 * per_ms))
    t0 = time.perf_counter()
    fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    batch = max(1, min(reps, int(HOLD_ISSUE_MS / max(issue_ms, 1e-3))))
    hold = min(HOLD_MAX_MS, 2.0 * batch * issue_ms + 0.5)
    HOLD["timings"] += 1
    total, done = 0.0, 0
    while done < reps:
        n = min(batch, reps - done)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold * per_ms))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        late = start.query()
        torch.cuda.synchronize()
        HOLD["batches"] += 1
        if late:
            HOLD["late"].append(what)
            retry = hold < HOLD_MAX_MS
            log(f"timing {what}: the card's {hold:.3g} ms sleep ended before "
                f"the host had issued {n} call(s) ({issue_ms:.3g} ms each); "
                + ("timed again behind a longer sleep" if retry else
                   "kept: this batch reads the host's pace"))
            if retry:
                hold = min(HOLD_MAX_MS, 4.0 * hold)
                continue
        total += start.elapsed_time(end)
        done += n
    return total / reps


def log_hold(card: str) -> None:
    """One line on the card-bound timings so far: how many, in how many
    held batches, and which batches the host issued late."""
    late = HOLD["late"]
    log(f"timing method: {HOLD['timings']} kernel timings by card-bound "
        f"CUDA events in {HOLD['batches']} held batches; start.query() "
        f"found the host late in {len(late)}"
        + (f": {', '.join(late)}" if late else "") + f" [{card}]")


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
        ms = cuda_ms(lambda: kn.knn_l2_fused(g, KNN_K), reps=reps,
                     what=f"knn_l2_fused N={n}")
        issued = issued_ms(lambda: kn.knn_l2_fused(g, KNN_K), reps=reps)
        plain_ms = cuda_ms(lambda: plain(g, KNN_K), reps=reps,
                           what=f"{plain.__name__} N={n}")
        # operations: the Gram matrix is symmetric (q.c and c.q, summed in
        # one feature order, are the same bits), so the function needs its
        # upper triangle only, diagonal (the row norms) included
        b_ms, b_by = bound(n * KNN_D * 4 + n * 4 + n * KNN_K * 8,
                           float(n * (n + 1) * KNN_D), "float32")
        per_shape.append(shape_line(
            "knn_l2_fused", f"N={n} D={KNN_D} k={KNN_K}", 1, ms,
            [(b_ms, b_by)], card, plain_ms=plain_ms, issued=issued))
        if n == KNN_MAIN:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        issued_ms=issued)
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
# and the 3xTF32 products' dropped lo*lo terms (about 2^-22 of a product);
# bf16 outputs carry 8 mantissa bits and v is rounded to bf16 before the
# 3x3 conv, so one flipped rounding moves y by a few bf16 ulps
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


def shape_line(kernel, shape, n, ms, bounds, card, plain_ms=None,
               issued=None):
    """Log and return the per-shape timing of `n` launches whose summed
    time is `ms` (cuda_ms): mean ms/launch, summed and mean bound, share
    of bound, the plain version's ms/launch where it was timed, and the
    same launches' ms by host-issued events (issued_ms, summed over the n)
    where that was timed."""
    b_ms, b_by = mean_bound(bounds)
    per = ms / n
    plain = "" if plain_ms is None else f"; plain {plain_ms:.4g} ms/launch"
    old = ("" if issued is None
           else f"; host-issued events {issued / n:.4g} ms/launch")
    log(f"timing {kernel} {shape}: {per:.4g} ms/launch x {n}, bound "
        f"{b_ms * n:.4g} ms summed ({b_by}), share of bound "
        f"{b_ms / per:.4g}{plain}{old} [{card}]")
    row = dict(shape=shape, launches_per_chunk=n, ms=per, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / per)
    if plain_ms is not None:
        row["plain_ms"] = plain_ms
    if issued is not None:
        row["issued_ms"] = issued / n
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
    per_shape, total_ms, total_issued, all_layers, all_bounds = (
        [], 0.0, 0.0, [], [])
    for h, c_end, layers, bounds in blocks:
        shape = f"[{CHUNK},{h},{h},{c_end}]"
        ms = cuda_ms(run(dn.dense_layer_fused, layers), reps=3, warmup=1,
                     what=f"dense_layer_fused bfloat16 {shape}")
        issued = issued_ms(run(dn.dense_layer_fused, layers), reps=3,
                           warmup=1)
        k_lo, k_hi = layers[0][-1], layers[-1][-1]
        per_shape.append(shape_line(
            "dense_layer_fused", f"{shape} k_in {k_lo}..{k_hi}",
            len(layers), ms, bounds, card, issued=issued))
        total_ms += ms
        total_issued += issued
        all_layers += layers
        all_bounds += bounds
    n_l = len(all_layers)
    # the plain layer issues ~20 launches: 8 layers behind one sleep keep
    # the launch queue far from full (58 at once filled it)
    plain = sum(cuda_ms(run(dn.dense_layer_reference, all_layers[i:i + 8]),
                        reps=1, warmup=1,
                        what=f"dense_layer_reference bfloat16 layers {i}..")
                for i in range(0, n_l, 8)) / n_l
    b_ms, b_by = mean_bound(all_bounds)
    return dict(max_abs_err=worst, ms=total_ms / n_l, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, issued_ms=total_issued / n_l,
                per_shape=per_shape)


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
    per_shape, total_ms, total_issued, bounds = [], 0.0, 0.0, []
    for x, a, b, w in shapes:
        bsz, h, _, c = x.shape
        m = bsz * (h // 2) * (h // 2)
        bounds.append(bound(
            x.numel() * 2 + w.numel() * 2 + m * (c // 2) * 2 + 8 * c,
            2.0 * m * c * (c // 2) + 4.0 * m * 4 * c, "bfloat16"))
        shape = f"[{bsz},{h},{h},{c}]->{c // 2}"
        ms = cuda_ms(lambda: dn.transition_fused(x, a, b, w), reps=10,
                     what=f"transition_fused bfloat16 {shape}")
        issued = issued_ms(lambda: dn.transition_fused(x, a, b, w), reps=10)
        per_shape.append(shape_line("transition_fused", shape, 1, ms,
                                    bounds[-1:], card, issued=issued))
        total_ms += ms
        total_issued += issued
    plain = cuda_ms(lambda: [dn.transition_reference(*s) for s in shapes],
                    reps=3, what="transition_reference bfloat16")
    b_ms, b_by = mean_bound(bounds)
    return dict(max_abs_err=worst, ms=total_ms / 3, plain_ms=plain / 3,
                bound_ms=b_ms, bound_by=b_by, issued_ms=total_issued / 3,
                per_shape=per_shape)


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
TRAIN_N = (800, 1600)      # patches per synthetic slide, drawn uniformly
                           # (cut to pay for the parallel group, PERF.md §4)
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


def grad_check(torch, named_cpu, named_dev, named_f64, run64, base64,
               dev):
    """Four models' `.grad` after the same step, judged by float64
    (wsi_hgnn_tpu_torch/train/gradcheck.py): the CPU in f32, the card in
    f32, the CPU in float64 (`named_f64`); `run64(model, device)` runs
    the float64 step in place, `base64` is the float64 model before it.
    The card's float64 step and the randomly rounded float64 steps (on
    the card) run only when some tensor is beyond GRAD_RTOL. Returns (one
    log fragment, the names of the tensors that fail)."""
    import copy

    from wsi_hgnn_tpu_torch.train import gradcheck

    named_f64 = list(named_f64)
    g64 = {n: p.grad.detach().double() for n, p in named_f64
           if p.requires_grad}

    def card64():
        m = copy.deepcopy(base64).to(dev)
        run64(m, dev)
        return m.named_parameters()

    return gradcheck.judge(
        named_cpu, named_dev, named_f64,
        lambda: gradcheck.rounding_spread(lambda m: run64(m, dev), base64,
                                          g64, device=dev), card64)


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
    from wsi_hgnn_tpu_torch.train.gradcheck import float64_default
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
    base64 = copy.deepcopy(model).double()
    out = {}
    for device, m in ((cpu, copy.deepcopy(model)), (dev, model.to(dev))):
        loss, _ = lattice_train_step(
            m, parse_optimizer(cfg["optimizer"], m.parameters()), loss_fn,
            lattice_to_torch(g_np, device),
            to_torch(labels, device, torch.int64), to_torch(weights, device),
            masks=TrainMasks(*(t.to(device) for t in masks)),
            drop_masks=[t.to(device) for t in drops])
        out[device.type] = (float(loss), list(m.named_parameters()))

    def run64(m, device):
        g = lattice_to_torch(g_np, device)
        with float64_default():
            lattice_train_step(
                m, parse_optimizer(cfg["optimizer"], m.parameters()), loss_fn,
                g._replace(feats=g.feats.double(), sim=g.sim.double()),
                to_torch(labels, device, torch.int64),
                to_torch(weights, device).double(),
                masks=TrainMasks(*(t.to(device) for t in masks)),
                drop_masks=[t.to(device) for t in drops])

    m64 = copy.deepcopy(base64)
    run64(m64, cpu)
    (l_cpu, p_cpu), (l_dev, p_dev) = out["cpu"], out[dev.type]
    return (abs(l_dev - l_cpu) / abs(l_cpu),) + grad_check(
        torch, p_cpu, p_dev, m64.named_parameters(), run64, base64, dev)


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
    fwd_ms = issued_ms(lambda: fwd(graph), reps=10) / n_test
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
    from wsi_hgnn_tpu_torch.train.gradcheck import float64_default
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
    base64 = copy.deepcopy(model).double()
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

    def run64(m, device):
        g = host.to_torch(device)
        with float64_default():
            typed_train_step(
                m, parse_optimizer(cfg["optimizer"], m.parameters()), loss_fn,
                g.replace(feat=g.feat.double(), sim=g.sim.double()),
                to_torch(labels, device, torch.int64),
                to_torch(weights, device).double(), hetero,
                masks=transforms.TrainMasks(*(t.to(device) for t in masks)),
                drops=DropSource(masks=[t.to(device) for t in drops.used]))

    m64 = copy.deepcopy(base64)
    run64(m64, cpu)
    (l_cpu, p_cpu), (l_dev, p_dev) = out["cpu"], out[dev.type]
    return (abs(l_dev - l_cpu) / abs(l_cpu),) + grad_check(
        torch, p_cpu, p_dev, m64.named_parameters(), run64, base64, dev)


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
        t_check = time.perf_counter()
        rel, text, failed = typed_step_on_card_vs_cpu(torch, dev, cfg,
                                                      trainer)
        t_check = time.perf_counter() - t_check
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
            f" slides; card vs CPU step ({t_check:.1f} s) loss rel err "
            f"{rel:.3g} (<= 1e-5), {text}")
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
# mil: the MIL bag baselines on the training cohort
# ---------------------------------------------------------------------------
MIL_RUNS = (("abmil", ()), ("dsmil", ("--remix-mode", "cov",
                                      "--num-prototypes", "1")),
            ("gtn", ("--hidden", "64", "--clusters", "100")))
MIL_TIMED_STEPS = 5


LOSS_RTOL = 1e-5    # the card's step loss against its reference step


def card_vs_cpu_step(torch, dev, model, step):
    """One step from the same weights on the card, the CPU and the CPU in
    float64 (`step(model, device, dtype)` runs it in place and returns the
    loss): (loss relative error, grad_check's result).

    The card's f32 step is held against the CPU's f32 step. A model that
    makes discrete choices (H2MIL's IHPool: fitness order statistics,
    nearest centres) can meet an input within f32 rounding of a tie (the
    smoke's 1509-patch bag does); the card's atomics then decide it one
    way or the other from run to run. Where the card's loss misses the
    CPU's f32 loss but is within LOSS_RTOL of the CPU's float64 loss, the
    card took float64's side: the CPU's float64 step is then its
    reference, for the loss and the gradients alike, at the same
    tolerances."""
    import copy

    from wsi_hgnn_tpu_torch.train.gradcheck import float64_default

    def run64(m, device):
        with float64_default():
            return step(m, device, torch.float64)

    cpu = torch.device("cpu")
    base64 = copy.deepcopy(model).double()
    m_cpu, m_dev = copy.deepcopy(model), copy.deepcopy(model).to(dev)
    l_cpu = float(step(m_cpu, cpu, torch.float32))
    l_dev = float(step(m_dev, dev, torch.float32))
    m64 = copy.deepcopy(base64)
    l64 = float(run64(m64, cpu))
    rel, ref, side = abs(l_dev - l_cpu) / abs(l_cpu), m_cpu, ""
    rel64 = abs(l_dev - l64) / abs(l64)
    if rel > LOSS_RTOL and rel64 <= LOSS_RTOL:
        side = (f"the card took float64's side of a tie (loss {l_dev:.7g}, "
                f"float64 {l64:.7g}, CPU f32 {l_cpu:.7g}): held against the "
                f"CPU's float64 step; ")
        rel, ref = rel64, m64
    text, failed = grad_check(
        torch, ref.named_parameters(), m_dev.named_parameters(),
        m64.named_parameters(), run64, base64, dev)
    return rel, side + text, failed


def mil_step_on_card_vs_cpu(torch, dev, kind, model, bag, edges, cap):
    """One train_mil step of a bag model on the card against the CPU
    (card_vs_cpu_step)."""
    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models.mil import pad_bag

    feats, mask = pad_bag(bag, capacity=cap)

    def step(m, device, dtype):
        f = torch.from_numpy(feats).to(device, dtype)
        msk = torch.from_numpy(mask).to(device)
        if kind == "gtn":
            opt = torch.optim.Adam(m.parameters(), lr=2e-4,
                                   weight_decay=5e-4)
            adj = train_mil.dense_adjacency(edges, cap, device).to(dtype)
            return train_mil.gtn_train_step(m, opt, f[None], adj,
                                            msk[None], 1)
        opt = torch.optim.Adam(m.parameters(), lr=2e-4, betas=(0.5, 0.9),
                               weight_decay=5e-3)
        return train_mil.bag_train_step(m, opt, kind, 2, f, msk, 1)

    return card_vs_cpu_step(torch, dev, model, step)


def mil_phase(torch, dev, card, kernels, root: Path, splits):
    """`python -m wsi_hgnn_tpu_torch.train_mil` (in process, on the card)
    over the training cohort's 12 slides as bags (their 800-1600 x 1024
    features, graphs built on the card), 2 folds and 2 epochs each, for
    abmil, dsmil with ReMix 'cov' (1 prototype: each prototype's shift
    vectors are a 1024-d multivariate normal draw on the host) and gtn
    (hidden 64, 100 clusters, its fold pickles written to mil_folds/ for
    the GraphCAM of mil_tree): finite summaries; then one step per model
    on the card against the CPU (grad_check), ms per step on the card
    and peak memory per model. Returns the launch counts of the runs."""
    import math

    import numpy as np

    from wsi_hgnn_tpu_torch import convert, train_mil
    from wsi_hgnn_tpu_torch.graph.typed_graph import bucket_size
    from wsi_hgnn_tpu_torch.models import mil
    from wsi_hgnn_tpu_torch.models.mil import pad_bag

    t_phase = time.perf_counter()
    names = [Path(p).stem for s in splits.values()
             for p in Path(s).read_text().split()]
    normals = set((root / "normal.txt").read_text().split())
    rows = ["name,label"] + [f"{n},{int(n[:16] not in normals)}"
                             for n in names]
    (root / "mil_labels.csv").write_text("\n".join(rows) + "\n")
    base = ["--feats-dir", str(root), "--labels", str(root / "mil_labels.csv"),
            "--folds", "2", "--epochs", "2", "--seed", "0"]
    bags, labels, _, coords = train_mil.load_bags(
        str(root), str(root / "mil_labels.csv"))
    check(len(bags) == 12 and sorted(np.bincount(labels)) == [6, 6],
          f"{len(bags)} bags, classes {np.bincount(labels)}")
    d = bags[0].shape[1]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results, failures = {}, []
    for kind, extra in MIL_RUNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if kind == "gtn":
            extra = extra + ("--save-dir", str(root / "mil_folds"))
        summary = train_mil.main(["--model", kind, *base, *extra])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(math.isfinite(summary[k]) for k in (
            "acc_mean", "f1_mean", "auc_mean")),
              f"train_mil {kind} summary {summary}")
        # the step alone, on the largest bag, at the run's capacity
        big = int(np.argmax([len(b) for b in bags]))
        if kind == "gtn":
            model = mil.GraphTransformer(2, d, 64, 100)
            cap = bucket_size(max(len(b) for b in bags), base=64)
            edges = mil.spatial_adjacency(
                [tuple(c) for c in train_mil.grid_coords(len(bags[big]))])
        else:
            model = (mil.ABMIL if kind == "abmil" else mil.DSMIL)(2, d)
            cap = max(len(b) for b in bags)
            edges = None
        convert.init_flax_like_(model, 0)
        rel, text, failed = mil_step_on_card_vs_cpu(
            torch, dev, kind, model, bags[big], edges, cap)
        if rel > 1e-5 or failed:
            failures.append(f"{kind}: loss {rel}, gradients of {failed}")
        m = model.to(dev)
        f, msk = (torch.from_numpy(a).to(dev) for a in pad_bag(bags[big],
                                                                 cap))
        if kind == "gtn":
            opt = torch.optim.Adam(m.parameters(), lr=2e-4, weight_decay=5e-4)
            adj = train_mil.dense_adjacency(edges, cap, dev)
            fn = lambda: train_mil.gtn_train_step(m, opt, f[None], adj,
                                                  msk[None], 1)
        else:
            opt = torch.optim.Adam(m.parameters(), lr=2e-4,
                                   betas=(0.5, 0.9), weight_decay=5e-3)
            fn = lambda: train_mil.bag_train_step(m, opt, kind, 2, f, msk, 1)
        step_ms = issued_ms(fn, reps=MIL_TIMED_STEPS)
        results[kind] = summary
        sizes = [len(b) for b in bags]
        log(f"mil {kind} (train_mil {' '.join(extra) or 'defaults'}; 12 bags "
            f"of {min(sizes)}-{max(sizes)} x {d}, 2 folds x 2 epochs, "
            f"capacity {cap}) in "
            f"{took:.1f} s: acc {summary['acc_mean']:.4f} f1 "
            f"{summary['f1_mean']:.4f} auc {summary['auc_mean']:.4f}; card vs "
            f"CPU step loss rel err {rel:.3g} (<= 1e-5), {text}")
        log(f"timing mil {kind}: {step_ms:.2f} ms per train step (CUDA "
            f"events, mean of {MIL_TIMED_STEPS} on the {len(bags[big])}-"
            f"instance bag), peak device memory of the k-fold run "
            f"{peak:.2f} GiB [{card}]")
    check(not failures, "card MIL steps differ from the CPU: "
          + "; ".join(failures))
    torch.cuda.synchronize()
    log(f"mil phase took {time.perf_counter() - t_phase:.1f} s")
    return kernels.launch_counts()


# ---------------------------------------------------------------------------
# mil_tree: H2MIL on trees, nested bags, GraphCAM, SimCLR (after mil)
# ---------------------------------------------------------------------------
H2MIL_TIMED_STEPS = 5
NESTED_SLIDES = 8      # 4 a class: each fold's held-out half tests 2 slides
NESTED_LOW = (5, 8)    # low-magnification tiles a slide, drawn uniformly
NESTED_THUMBS = 2      # slides given a -1.jpeg thumbnail by hand
NESTED_BATCH = 32      # load_nested_trees' encoder chunk
SIMCLR_CORPUS = 320    # 256 x 256 JPEG patches
SIMCLR_BATCH = 64      # the tool's default: B = 128 through the backbone
SIMCLR_EPOCHS = 2
SIMCLR_SLIDES = (6, 16)  # extraction: slide directories x patches each
SIMCLR_CHECK = 2       # images of the card-vs-CPU SimCLR step
SIMCLR_TIMED_STEPS = 3


def jpeg_tile(path: Path, rng, size: int = PATCH) -> None:
    """A seeded H&E-coloured tile, written as JPEG."""
    import numpy as np
    from PIL import Image

    base = np.array([200, 120, 160]) + rng.randint(-40, 40, 3)
    img = np.clip(base + rng.randint(-30, 30, (size, size, 3)), 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path, quality=90)


def write_nested_bags(root: Path, seed: int = 80):
    """NESTED_SLIDES two-magnification bags in the tiler's nested_patches
    layout (<class>/<slide>/<x>_<y>.jpeg, children under <x>_<y>/), the
    first NESTED_THUMBS with a `-1.jpeg` thumbnail. Returns (labels CSV,
    the encoder chunks load_nested_trees makes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rows, chunks = ["name,label"], 0
    for i in range(NESTED_SLIDES):
        label = i % 2
        bag = root / ("tumor" if label else "normal") / f"nested{i}"
        bag.mkdir(parents=True)
        n_low = int(rng.randint(NESTED_LOW[0], NESTED_LOW[1] + 1))
        n_high = 0
        for c in rng.permutation(16)[:n_low]:
            x, y = int(c % 4), int(c // 4)
            jpeg_tile(bag / f"{x}_{y}.jpeg", rng)
            kids = [(2 * x + dx, 2 * y + dy) for dx in (0, 1) for dy in (0, 1)
                    if rng.rand() < 0.75]
            if kids:
                (bag / f"{x}_{y}").mkdir()
            for hx, hy in kids:
                jpeg_tile(bag / f"{x}_{y}" / f"{hx}_{hy}.jpeg", rng)
            n_high += len(kids)
        if i < NESTED_THUMBS:
            jpeg_tile(bag / "-1.jpeg", rng)
        chunks += (-(-n_low // NESTED_BATCH) + -(-n_high // NESTED_BATCH)
                   + (i < NESTED_THUMBS))
        rows.append(f"nested{i},{label}")
    (root / "labels.csv").write_text("\n".join(rows) + "\n")
    return root / "labels.csv", chunks


def launch_delta(kernels, before):
    return {k: v - before[k] for k, v in kernels.launch_counts().items()}


def f32_kernel_timing(torch, dn, dev, gen, card):
    """SimCLR's frozen backbone shapes in f32 at B = CHUNK (two views of a
    64-image batch): every dense layer of each block and the three
    transitions, each against its plain version on the same operands,
    timed by CUDA events against two bounds from the same bytes: the
    operations at the f32 peak outside the tensor cores (67 TF/s) and at
    the 3xTF32 rate (495 / 3 TF/s). Returns the summary rows {kernel: {ms,
    bound_ms, bound_by (f32), bound_tf32x3_ms, bound_tf32x3_by,
    plain_ms}}."""
    f32 = torch.float32
    peaks = ("float32", "tf32x3")

    def line(kernel, shape, n, ms, bounds, plain_ms, issued):
        per = ms / n
        parts = []
        for peak in peaks:
            b_ms, b_by = mean_bound(bounds[peak])
            parts.append(f"bound at {peak} {b_ms:.4g} ms ({b_by}), share "
                         f"{b_ms / per:.4g}")
        log(f"timing {kernel} float32 {shape}: {per:.4g} ms/launch x {n}; "
            f"{'; '.join(parts)}; plain {plain_ms:.4g} ms/launch; "
            f"host-issued events {issued / n:.4g} ms/launch [{card}]")

    def summary(ms, n, bounds, plain_ms):
        row = dict(ms=ms / n, plain_ms=plain_ms / n)
        for peak, key in zip(peaks, ("bound", "bound_tf32x3")):
            row[f"{key}_ms"], row[f"{key}_by"] = mean_bound(bounds[peak])
        return row

    out = {}
    all_bounds = {peak: [] for peak in peaks}
    total_ms, total_plain, n_all = 0.0, 0.0, 0
    for h, ch, n_layers in BLOCKS:
        c_end = ch + 32 * n_layers
        layers, bounds = [], {peak: [] for peak in peaks}
        for li in range(n_layers):
            k_in = ch + 32 * li
            ops = layer_operands(torch, dev, gen, h, c_end, k_in, f32)
            check_layer(torch, dn, ops, h, k_in, "float32")
            x = ops[0] if not layers else layers[0][0]
            layers.append((x,) + ops[1:] + (k_in,))
            px = CHUNK * h * h
            for peak in peaks:
                bounds[peak].append(bound(
                    px * (k_in + 32) * 4 + (k_in * 128 + 128 * 288) * 4,
                    2.0 * px * (k_in * 128 + 9 * 128 * 32), peak))

        def run(fn):
            def go():
                for x, a1, b1, w1f, b2, w2cat, k_in in layers:
                    fn(x, a1, b1, w1f, b2, w2cat,
                       n_active_groups=-(-k_in // 128), slot=k_in // 32)
            return go
        shape = f"[{CHUNK},{h},{h},{c_end}]"
        ms = cuda_ms(run(dn.dense_layer_fused), reps=3, warmup=1,
                     what=f"dense_layer_fused float32 {shape}")
        issued = issued_ms(run(dn.dense_layer_fused), reps=3, warmup=1)
        plain = cuda_ms(run(dn.dense_layer_reference), reps=3, warmup=1,
                        what=f"dense_layer_reference float32 {shape}")
        line("dense_layer_fused", shape, n_layers, ms, bounds,
             plain / n_layers, issued)
        for peak in peaks:
            all_bounds[peak] += bounds[peak]
        total_ms, total_plain, n_all = (total_ms + ms, total_plain + plain,
                                        n_all + n_layers)
    out["dense_layer_fused"] = summary(total_ms, n_all, all_bounds,
                                       total_plain)
    bounds = {peak: [] for peak in peaks}
    total_ms, total_plain = 0.0, 0.0
    for h, c in ((64, 256), (32, 512), (16, 1024)):
        kw = dict(generator=gen, device=dev)
        x = torch.randn(CHUNK, h, h, c, **kw)
        a = torch.rand(1, c, **kw) + 0.5
        b = torch.randn(1, c, **kw) * 0.1
        w = torch.randn(c, c // 2, **kw) * (2.0 / c) ** 0.5
        ok, err = close(torch, dn.transition_fused(x, a, b, w),
                        dn.transition_reference(x, a, b, w), "float32")
        check(ok, f"transition f32 mismatch H={h} C={c}: max|err| {err:.3g}")
        log(f"transition [{CHUNK},{h},{h},{c}] float32: max|err| {err:.3g} "
            f"(rtol,atol {TOL['float32']})")
        m = CHUNK * (h // 2) * (h // 2)
        one = {peak: [bound(
            x.numel() * 4 + w.numel() * 4 + m * (c // 2) * 4 + 8 * c,
            2.0 * m * c * (c // 2) + 4.0 * m * 4 * c, peak)] for peak in peaks}
        shape = f"[{CHUNK},{h},{h},{c}]->{c // 2}"
        ms = cuda_ms(lambda: dn.transition_fused(x, a, b, w), reps=10,
                     what=f"transition_fused float32 {shape}")
        issued = issued_ms(lambda: dn.transition_fused(x, a, b, w), reps=10)
        plain = cuda_ms(lambda: dn.transition_reference(x, a, b, w), reps=10,
                        what=f"transition_reference float32 {shape}")
        line("transition_fused", shape, 1, ms, one, plain, issued)
        for peak in peaks:
            bounds[peak] += one[peak]
        total_ms, total_plain = total_ms + ms, total_plain + plain
    out["transition_fused"] = summary(total_ms, 3, bounds, total_plain)
    for name, r in out.items():
        log(f"timing {name} float32 at B={CHUNK} (SimCLR's backbone): "
            f"{r['ms']:.4g} ms/launch; bound {r['bound_ms']:.4g} ms at f32 "
            f"({r['bound_by']}, share {r['bound_ms'] / r['ms']:.4g}), "
            f"{r['bound_tf32x3_ms']:.4g} ms at 3xTF32 "
            f"({r['bound_tf32x3_by']}, share "
            f"{r['bound_tf32x3_ms'] / r['ms']:.4g}); plain "
            f"{r['plain_ms']:.4g} ms [{card}]")
    return out


def backbone_f32_timing(torch, dev, card, reps: int = 5):
    """SimCLR's frozen backbone alone: one seeded KimiaNet forward through
    the f32 kernel chain (`kimianet_fused_apply`) at B = CHUNK views of
    256 x 256, CUDA events, mean of `reps`."""
    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.models.featurizers import (KimiaNet,
                                                       fuse_kimianet,
                                                       kimianet_fused_apply)

    model = convert.init_flax_like_(KimiaNet(), seed=5).eval()
    fp = fuse_kimianet(convert.to_flax_variables(model), dtype=torch.float32,
                       device=dev)
    x = torch.rand(CHUNK, PATCH, PATCH, 3, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(6))
    with torch.inference_mode():
        ms = cuda_ms(lambda: kimianet_fused_apply(fp, x), reps=reps,
                     what="kimianet f32 forward")
    log(f"timing kimianet f32 forward [{CHUNK},{PATCH},{PATCH},3] (SimCLR's "
        f"frozen backbone, 58 + 3 kernel launches): {ms:.2f} ms (card-bound "
        f"CUDA events, mean of {reps}) [{card}]")
    return ms


def mma_rate(torch, dev, card, iters: int = 2000):
    """Peak issue rate of mma.sync, TF32 and bf16: csrc/mma_rate.cu
    (independent MMAs from registers, no loads) at one and two blocks of
    256, 512 and 1024 threads per SM, CUDA events, mean of 3. The TF32
    rate bounds the f32 kernels' 3xTF32 products through mma.sync (a third
    of it); the data-sheet TF32 peak is wgmma's."""
    import ctypes
    from wsi_hgnn_tpu_torch.kernels import _build

    fn = _build.load("mma_rate").mma_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(2 * sms * 1024, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kind, per_mma in (("tf32", 2 * 16 * 8 * 8), ("bf16", 2 * 16 * 8 * 16)):
        for threads in (256, 512, 1024):
            for per_sm in (1, 2):
                blocks = per_sm * sms

                def launch(n=iters):
                    _build.check(fn(out.data_ptr(), kind == "tf32", blocks,
                                    threads, n, stream), "mma_rate")
                launch(10)
                ms = cuda_ms(launch, reps=3, warmup=0,
                             what=f"mma_rate {kind} {blocks}x{threads}")
                # every warp issues 8 MMAs an iteration
                ops = blocks * (threads // 32) * iters * 8 * per_mma
                log(f"mma.sync {kind}: {blocks} blocks x {threads} threads: "
                    f"{ops / ms / 1e9:.1f} TF/s [{card}]")


def graphcam_card_vs_cpu(torch, np, dev, pkl, bag):
    """The bag's raw GraphCAM of every class on the card and on the CPU,
    judged as PR 8's explanation scores: each within SCORE_RTOL |cpu| +
    atol, atol 2 x 3 x the largest change randomly rounded float64 runs
    (on the card) make; an all-zero or sign-flipped cam must fail it.
    Returns (the card's cams, log text)."""
    from wsi_hgnn_tpu_torch.tools import vis_graphcam as vis
    from wsi_hgnn_tpu_torch.train.gradcheck import output_spread

    cpu = torch.device("cpu")
    feats, xy = vis.load_bag(str(bag))
    n = len(feats)
    m_dev, meta = vis.load_gtn(str(pkl), dev)
    m_cpu, _ = vis.load_gtn(str(pkl), cpu)
    cap = int(meta["cap"])
    got = vis.raw_cams(m_dev, *vis.bag_inputs(feats, xy, cap, dev), n
                       ).cpu().numpy()
    want = vis.raw_cams(m_cpu, *vis.bag_inputs(feats, xy, cap, cpu), n
                        ).numpy()
    m64 = m_dev.double()
    f64, a64, msk = vis.bag_inputs(feats, xy, cap, dev)
    f64, a64 = f64.double(), a64.double()
    want64 = vis.raw_cams(m64, f64, a64, msk, n)
    atol = 2.0 * 3.0 * output_spread(
        lambda: vis.raw_cams(m64, f64, a64, msk, n), want64, device=dev)
    over = scores_over(np, got, want, atol)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    flipped = scores_over(np, -got, want, atol)
    zeros = scores_over(np, np.zeros_like(got), want, atol)
    check(over <= 1.0 and flipped > 1.0 and zeros > 1.0,
          f"GraphCAM card vs CPU: largest error over its bound {over:.3g} "
          f"(sign-flipped {flipped:.3g}, all-zero {zeros:.3g}; rel L2 "
          f"{rel:.3g}, atol {atol:.3g})")
    return got, (f"GraphCAM card vs CPU over {got.shape[0]} classes x {n} "
                 f"nodes: rel L2 {rel:.3g}, largest error over rtol "
                 f"{SCORE_RTOL:g} + atol {atol:.3g} {over:.3g} (<= 1); "
                 f"sign-flipped {flipped:.3g}x, all-zero {zeros:.3g}x over")


def mil_tree_phase(torch, dev, card, kernels, root: Path, dn, gen):
    """The rest of the MIL baselines and the GTN feature pipeline on the
    card (in process, each through its `python -m` entry point):

    1. `train_mil --model h2mil` on the cohort's 12 bags (synthetic parent
       level, --cell 4; hidden 64, k1 8, k2 32), 2 folds x 2 epochs;
    2. `train_mil --model h2mil --nested-bags --encoder kimia` over
       NESTED_SLIDES seeded two-magnification bags written in the tiler's
       layout (two with a thumbnail): 58 dense-layer and 3 transition
       launches per encoder chunk;
    3. `tools.vis_graphcam` on the mil phase's gtn fold pickle and the
       largest bag;
    4. `tools.pretrain_simclr` over SIMCLR_CORPUS JPEG patches (KimiaNet
       frozen, batch 64, 2 epochs, warmup 1), `--extract` over
       SIMCLR_SLIDES slide directories, and `train_mil --model gtn` on
       the extracted bags.

    Counters are zeroed before 1. and read after 4. Then the checks and
    timings: finite summaries; H2MIL and SimCLR steps on the card against
    the CPU (grad_check, dropout off); the nested bags' level-2 features
    equal to the encoder called directly; the card's GraphCAM against the
    CPU's; the extracted features against the KimiaNet module in f32; ms
    per H2MIL step, per GraphCAM class and per SimCLR step, and the f32
    kernels at B = 128. Returns the launch counts of the main path."""
    import math

    import numpy as np

    from wsi_hgnn_tpu_torch import convert, train_mil
    from wsi_hgnn_tpu_torch.models.featurizers import make_cnn_encoder
    from wsi_hgnn_tpu_torch.models.mil import H2MIL, graphcam, simclr
    from wsi_hgnn_tpu_torch.models.mil.h2mil import (scan_nested_bag,
                                                     tree_to_torch)
    from wsi_hgnn_tpu_torch.pipeline.patches import iter_patch_batches
    from wsi_hgnn_tpu_torch.tools import pretrain_simclr, vis_graphcam
    from wsi_hgnn_tpu_torch.utils import to_torch

    def finite(summary, what):
        check(all(math.isfinite(summary[k]) for k in (
            "acc_mean", "f1_mean", "auc_mean")), f"{what} summary {summary}")

    t_phase = time.perf_counter()
    labels = root / "mil_labels.csv"
    base = ["--feats-dir", str(root), "--labels", str(labels), "--folds", "2",
            "--epochs", "2", "--seed", "0"]
    bags, _, names, coords = train_mil.load_bags(str(root), str(labels))
    big = int(np.argmax([len(b) for b in bags]))
    d = bags[0].shape[1]
    nested, chunks = write_nested_bags(root / "nested")
    corpus, slides = root / "simclr" / "corpus", root / "simclr" / "slides"
    rng = np.random.RandomState(90)
    for j in range(SIMCLR_CORPUS):
        (corpus / f"c{j % 4}").mkdir(parents=True, exist_ok=True)
        jpeg_tile(corpus / f"c{j % 4}" / f"{j}.jpeg", rng)
    n_sl, per_sl = SIMCLR_SLIDES
    for i in range(n_sl):
        (slides / f"sim{i}").mkdir(parents=True)
        for j in range(per_sl):
            jpeg_tile(slides / f"sim{i}" / f"{j % 4}_{j // 4}.jpeg", rng)
    (root / "simclr" / "labels.csv").write_text("\n".join(
        ["name,label"] + [f"sim{i},{i % 2}" for i in range(n_sl)]) + "\n")
    log(f"mil_tree inputs written in {time.perf_counter() - t_phase:.1f} s")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    # 1. H2MIL on the cohort
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h2 = train_mil.main(["--model", "h2mil", *base])
    torch.cuda.synchronize()
    h2_s = time.perf_counter() - t0
    h2_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite(h2, "train_mil h2mil")
    # 2. real two-level trees, KimiaNet on the card
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    nb = train_mil.main(["--model", "h2mil", "--nested-bags", "--encoder",
                         "kimia", "--feats-dir", str(nested.parent),
                         "--labels", str(nested), "--folds", "2",
                         "--epochs", "2"])
    torch.cuda.synchronize()
    nb_s = time.perf_counter() - t0
    nb_launch = launch_delta(kernels, before)
    finite(nb, "train_mil h2mil --nested-bags")
    # 3. GraphCAM of the gtn fold
    pkl = root / "mil_folds" / "gtn_fold0.pkl"
    bag = root / f"{names[big]}.npz"
    t0 = time.perf_counter()
    cams, probs = vis_graphcam.main(["--bag", str(bag), "--params", str(pkl),
                                     "--out", str(root / "graphcam")])
    torch.cuda.synchronize()
    cam_s = time.perf_counter() - t0
    check(np.isfinite(cams).all() and cams.shape == (2, len(bags[big]))
          and (root / "graphcam.png").exists()
          and abs(float(probs.sum()) - 1.0) < 1e-5,
          f"vis_graphcam output {cams.shape}, probs {probs}")
    # 4. SimCLR pretraining, extraction, GTN on the extracted bags
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    best = pretrain_simclr.main([
        "--patch-dir", str(corpus), "--out", str(root / "simclr" / "run"),
        "--epochs", str(SIMCLR_EPOCHS), "--warmup-epochs", "1",
        "--batch", str(SIMCLR_BATCH)])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre_launch = launch_delta(kernels, before)
    n_val = max(int(SIMCLR_CORPUS * 0.1), SIMCLR_BATCH)
    forwards = SIMCLR_EPOCHS * ((SIMCLR_CORPUS - n_val) // SIMCLR_BATCH
                                + n_val // SIMCLR_BATCH)
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    written = pretrain_simclr.main([
        "--extract", "--ckpt", best, "--patch-dir", str(slides),
        "--out", str(root / "simclr" / "feats")])
    torch.cuda.synchronize()
    ext_s = time.perf_counter() - t0
    ext_launch = launch_delta(kernels, before)
    gtn = train_mil.main(["--model", "gtn", "--feats-dir",
                          str(root / "simclr" / "feats"), "--labels",
                          str(root / "simclr" / "labels.csv"), "--folds", "2",
                          "--epochs", "2"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    finite(gtn, "train_mil gtn on SimCLR features")
    for name, per in PER_CHUNK.items():
        check(nb_launch[name] == per * chunks,
              f"nested bags launched {nb_launch[name]} {name}, want "
              f"{per} x {chunks} chunks")
        check(pre_launch[name] == per * forwards,
              f"pretrain_simclr launched {pre_launch[name]} {name}, want "
              f"{per} x {forwards} forwards")
        check(ext_launch[name] == per * n_sl,
              f"--extract launched {ext_launch[name]} {name}, want "
              f"{per} x {n_sl} slides")
    check(launches["knn_l2_fused"] == 0, f"mil_tree launched {launches}")
    log(f"mil_tree main path: h2mil k-fold {h2_s:.1f} s (acc "
        f"{h2['acc_mean']:.4f} auc {h2['auc_mean']:.4f}, peak "
        f"{h2_peak:.2f} GiB); nested bags {nb_s:.1f} s ({NESTED_SLIDES} "
        f"slides, {chunks} encoder chunks, {nb_launch['dense_layer_fused']} "
        f"dense / {nb_launch['transition_fused']} transition launches, acc "
        f"{nb['acc_mean']:.4f}); vis_graphcam {cam_s:.1f} s (probs "
        f"{np.round(probs, 4).tolist()}); pretrain_simclr {pre_s:.1f} s "
        f"({forwards} backbone forwards at B={2 * SIMCLR_BATCH}, "
        f"{pre_launch['dense_layer_fused']} dense launches); --extract "
        f"{ext_s:.1f} s ({len(written)} bags); gtn on them acc "
        f"{gtn['acc_mean']:.4f} [{card}]")

    failures = []
    # H2MIL: one step on the card against the CPU, then the timed step
    tree = train_mil.synthetic_trees(bags, coords, 4)[big]
    model = convert.init_flax_like_(H2MIL(d, 64, 2, dropout=0.0), 0)

    def h2_step(m, device, dtype):
        opt = torch.optim.Adam(m.parameters(), lr=2e-4, weight_decay=5e-4)
        return train_mil.h2mil_train_step(
            m, opt, tree_to_torch(tree, device, dtype), 1)

    rel, text, failed = card_vs_cpu_step(torch, dev, model, h2_step)
    if rel > 1e-5 or failed:
        failures.append(f"h2mil: loss {rel}, gradients of {failed}")
    log(f"mil_tree h2mil card vs CPU step loss rel err {rel:.3g} (<= 1e-5), "
        f"{text}")
    m = convert.init_flax_like_(H2MIL(d, 64, 2), 0).to(dev)
    opt = torch.optim.Adam(m.parameters(), lr=2e-4, weight_decay=5e-4)
    t_dev = tree_to_torch(tree, dev)
    g_drop = torch.Generator(device=dev).manual_seed(1)
    h2_ms = issued_ms(lambda: train_mil.h2mil_train_step(m, opt, t_dev, 1,
                                                         g_drop),
                      reps=H2MIL_TIMED_STEPS)
    log(f"timing mil_tree h2mil: {h2_ms:.2f} ms per train step (CUDA "
        f"events, mean of {H2MIL_TIMED_STEPS}, the {len(bags[big])}-patch "
        f"bag: {int(tree.node_mask.sum())} tree nodes, "
        f"{int(tree.edge_mask.sum())} edges), peak of the k-fold run "
        f"{h2_peak:.2f} GiB [{card}]")

    # nested bags: one slide's level-2 features from the encoder directly
    encoder = make_cnn_encoder("kimia", {"feature_dim": 1024}, {}, {},
                               pad_batch_to=NESTED_BATCH, device=dev)
    trees, _, slide_names = train_mil.load_nested_trees(
        str(nested.parent), str(nested), "kimia", encoder=encoder)
    _, _, high, _, _, _ = scan_nested_bag(
        nested.parent / "normal" / slide_names[0])
    direct = np.concatenate([encoder(b)[0] for b in
                             iter_patch_batches(high, NESTED_BATCH)])
    first = trees[0]
    n_real = int(first.node_mask.sum())
    check(np.array_equal(first.feats[n_real - len(high):n_real], direct),
          "nested bag level-2 features differ from the encoder's")

    # GraphCAM: card against CPU, then ms per class
    _, cam_text = graphcam_card_vs_cpu(torch, np, dev, pkl, bag)
    log(f"mil_tree {cam_text}")
    g_model, meta = vis_graphcam.load_gtn(str(pkl), dev)
    feats, xy = vis_graphcam.load_bag(str(bag))
    inputs = vis_graphcam.bag_inputs(feats, xy, int(meta["cap"]), dev)
    cam_ms = issued_ms(lambda: graphcam(g_model, *inputs, 0), reps=3)
    log(f"timing mil_tree graphcam: {cam_ms:.2f} ms per class (CUDA events, "
        f"{len(feats)} nodes at capacity {meta['cap']}, 100 clusters) "
        f"[{card}]")

    # SimCLR: extracted features against the module, a step on the card
    # against the CPU, ms per step
    s_model, _ = pretrain_simclr.load_checkpoint(best, dev)
    sl0 = sorted((slides / "sim0").glob("*.jpeg"))
    with np.load(root / "simclr" / "feats" / "sim0.npz") as z:
        got_f = torch.from_numpy(z["feat"]).to(dev)
    with torch.inference_mode():
        want_f = s_model(to_torch(pretrain_simclr.load_batch(sl0, PATCH),
                                  dev))[0]
    err = float((got_f - want_f).abs().max())
    check(bool(torch.allclose(got_f, want_f, rtol=1e-3, atol=1e-4)),
          f"extracted features vs KimiaNet module: max|err| {err:.3g}")
    imgs = torch.from_numpy(pretrain_simclr.load_batch(
        sorted(corpus.rglob("*.jpeg"))[:SIMCLR_CHECK], PATCH))
    views = simclr.draw_views(SIMCLR_CHECK, PATCH, PATCH,
                              torch.Generator().manual_seed(3))
    check_model, _ = pretrain_simclr.load_checkpoint(best, torch.device("cpu"))
    for p in check_model.backbone.parameters():
        p.requires_grad_(False)

    def s_step(mdl, device, dtype):
        if dtype == torch.float32:
            project, _ = pretrain_simclr.make_projector(mdl, "kimia", False,
                                                        device)
        else:
            def project(x):
                with torch.no_grad():
                    out_1 = mdl(x)[0]
                return mdl.fc_4(out_1)
        opt = torch.optim.Adam(mdl.fc_4.parameters(), lr=1e-5,
                               weight_decay=1e-5)
        return simclr.simclr_train_step(project, opt, imgs.to(device, dtype),
                                        views=views)

    rel, text, failed = card_vs_cpu_step(torch, dev, check_model, s_step)
    if rel > 1e-5 or failed:
        failures.append(f"simclr: loss {rel}, gradients of {failed}")
    log(f"mil_tree simclr card vs CPU step ({SIMCLR_CHECK} images) loss rel "
        f"err {rel:.3g} (<= 1e-5), {text}; extracted features vs the "
        f"module max|err| {err:.3g} (rtol 1e-3, atol 1e-4)")
    project, trained = pretrain_simclr.make_projector(s_model, "kimia", False,
                                                      dev)
    opt = torch.optim.Adam(trained, lr=1e-5, weight_decay=1e-5)
    batch = to_torch(pretrain_simclr.load_batch(
        sorted(corpus.rglob("*.jpeg"))[:SIMCLR_BATCH], PATCH), dev)
    g_views = torch.Generator(device=dev).manual_seed(4)
    step_ms = issued_ms(lambda: simclr.simclr_train_step(project, opt,
                                                         batch, g_views),
                        reps=SIMCLR_TIMED_STEPS, warmup=1)
    log(f"timing mil_tree simclr: {step_ms:.2f} ms per train step (CUDA "
        f"events, mean of {SIMCLR_TIMED_STEPS}; batch {SIMCLR_BATCH}: "
        f"{2 * SIMCLR_BATCH} views of {PATCH}x{PATCH} through the f32 "
        f"kernel chain, fc_4 trained) [{card}]")
    f32_kernel_timing(torch, dn, dev, gen, card)
    check(not failures, "card steps differ from the CPU: "
          + "; ".join(failures))
    torch.cuda.synchronize()
    log(f"mil_tree phase took {time.perf_counter() - t_phase:.1f} s")
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
    Then the same config set to `knn_impl: approx` builds slide 0 again
    (one KNN launch; a graph bit-equal to the pallas build), and
    `public_api_checks` runs. Returns the launch counts of both
    constructions, summed. `gnn` overrides the trainer's GNN keys (a small
    CPU rehearsal)."""
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

    # the same config with knn_impl: approx over slide 0 alone: the KNN
    # kernel once, and every array written equal to the pallas build's
    # (the same encoder weights and kernels on the same patches)
    acfg = dict(gcfg, knn_impl="approx",
                patch_path=str(root / "approx_patches") + "/",
                out_dir=str(root / "graphs_approx"))
    (root / "approx_patches" / "normal").mkdir(parents=True)
    (root / "approx_patches" / "normal" / names[0]).symlink_to(
        Path(patch_path) / "normal" / names[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    check(construct_all(acfg, hcfg, kcfg, device=dev) == 1,
          "the approx construction wrote no slide")
    t_approx = time.perf_counter() - t0
    approx_launches = kernels.launch_counts()
    a_chunks = -(-sizes[0] // CHUNK)
    want = {"knn_l2_fused": 1,
            **{k: v * a_chunks for k, v in PER_CHUNK.items()}}
    check(approx_launches == want,
          f"approx construction launched {approx_launches}, want {want}")
    differ = []
    for kind in ("heterogeneous", "homogeneous"):
        with np.load(out / kind / f"{names[0]}.npz") as z_p, np.load(
                Path(acfg["out_dir"]) / kind / f"{names[0]}.npz") as z_a:
            check(sorted(z_p.files) == sorted(z_a.files),
                  f"approx {kind} file holds {z_a.files}, want {z_p.files}")
            differ += [f"{kind}/{key}" for key in z_p.files
                       if not np.array_equal(z_p[key], z_a[key])]
    check(np.array_equal(np.load(Path(acfg["out_dir"]) / "node_types"
                                 / f"{names[0]}.npy"), types)
          and not differ,
          f"knn_impl approx graph of {names[0]} differs from the pallas "
          f"build in {differ}")
    public_api_checks(torch, np, dev, card, kernels, root, hcfg, hover)

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
    log(f"construct with knn_impl approx: {names[0]} ({sizes[0]} patches) "
        f"in {t_approx:.2f} s, launches {approx_launches}, every array "
        f"written equal to the pallas build's [{card}]")
    log(f"timing construct per slide (host clock; mean of {n_slides} "
        f"slides, {sum(sizes) / n_slides:.0f} patches): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(per.items()))
        + f"; {t_construct / n_slides * 1e3:.1f} ms per slide in all "
        f"(decode runs on a prefetch thread, overlapped) [{card}]")
    return {k: v + approx_launches[k] for k, v in launches.items()}


API_N = 2048      # build_edges_device / knn_edges check: the main bucket
API_LIVE = 2000


def public_api_checks(torch, np, dev, card, kernels, root: Path, hcfg,
                      hover):
    """The construction helpers a user calls directly, on the card:
    build_edges_device and knn_edges at N = 2048, D = 1024, radius 9 on
    exact-arithmetic features (one KNN launch each; indices, masks and
    signs equal to the CPU plain versions, sim to 1e-5), make_hover_typing
    on a few pool patches (equal to make_hover_typing_device's types),
    and profiling.trace around one KNN inside annotate("knn") and a
    device span "knn": the trace must hold the KNN kernel among its device
    events and the annotation, and the spans file beside it the span with
    its card time and the card's idle time inside it. These launches are
    checks, not main-path launches: none is counted."""
    import json as _json

    from wsi_hgnn_tpu_torch import profiling
    from wsi_hgnn_tpu_torch.graph import build_edges_device
    from wsi_hgnn_tpu_torch.models.featurizers import (
        make_hover_typing, make_hover_typing_device)
    from wsi_hgnn_tpu_torch.ops.knn import knn_edges, knn_lookup

    t0 = time.perf_counter()
    f = knn_exact_features(torch, torch.Generator().manual_seed(7), API_N,
                           "ties")
    mask = torch.arange(API_N) < API_LIVE
    want_e = build_edges_device(f, RADIUS, mask)       # CPU: plain versions
    want_k = knn_edges(f, RADIUS - 1, mask)
    fd, md = f.to(dev), mask.to(dev)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    got_e = [t.cpu() for t in build_edges_device(fd, RADIUS, md)]
    delta_e = launch_delta(kernels, before)["knn_l2_fused"]
    got_k = [t.cpu() for t in knn_edges(fd, RADIUS - 1, md)]
    delta_k = launch_delta(kernels, before)["knn_l2_fused"] - delta_e
    check(delta_e == 1 and delta_k == 1,
          f"build_edges_device / knn_edges launched the KNN {delta_e} / "
          f"{delta_k} times on the card, want 1 / 1")
    sim_err = (got_e[3] - want_e[3]).abs().max().item()
    # esign is sim > 0: compared where sim clears its own tolerance
    clear = want_e[3].abs() > 1e-5
    same = (torch.equal(got_e[0], want_e[0])
            and torch.equal(got_e[1], want_e[1])
            and torch.equal(got_e[4], want_e[4])
            and torch.equal(got_e[2][clear], want_e[2][clear])
            and torch.equal(got_k[0], want_k[0])
            and torch.equal(got_k[1], want_k[1]))
    check(same and sim_err <= 1e-5,
          f"build_edges_device / knn_edges on the card differ from the CPU "
          f"plain versions (indices, masks and signs equal: {same}; sim "
          f"max|err| {sim_err:.3g} against 1e-5)")

    px = patch_pool(N_CHECK, seed=60)
    got_t = make_hover_typing(hcfg, N_TYPES, variables=hover)(px)
    typing_dev = make_hover_typing_device(hcfg, N_TYPES, dev, hover, 0)
    with torch.inference_mode():
        want_t = typing_dev(torch.from_numpy(px).to(dev).float() / 255.0)
    check(got_t.dtype == np.int32
          and np.array_equal(got_t, want_t.cpu().numpy()),
          f"make_hover_typing gave {got_t}, make_hover_typing_device "
          f"{want_t.cpu().numpy()}")

    trace_dir = root / "trace"
    g = torch.randn(API_N, KNN_D, device=dev)
    with profiling.trace(str(trace_dir)):
        with profiling.annotate("knn"), profiling.span("knn", device=dev):
            knn_lookup(g, RADIUS - 1)
            torch.cuda.synchronize()
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    check(len(files) == 1 and len(list(trace_dir.iterdir())) == 2,
          f"profiling.trace wrote {sorted(trace_dir.iterdir())}")
    events = _json.loads(files[0].read_text())["traceEvents"]
    device = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    check(any("knn_l2" in name for name in device)
          and any(e.get("name") == "knn" for e in events),
          f"trace holds device kernels {device[:8]} and annotation "
          f"'knn': {any(e.get('name') == 'knn' for e in events)}")
    knn_span = _json.loads(Path(str(files[0]) + ".spans.json").read_text()
                           )["spans"].get("knn") or {}
    check(knn_span.get("count") == 1 and (knn_span.get("device_s") or 0) > 0
          and knn_span.get("card_idle_s") is not None
          and 0 <= knn_span["card_idle_s"] <= knn_span["host_s"],
          f"the spans file beside the trace holds span 'knn' {knn_span}")
    log(f"public helpers on the card: build_edges_device and knn_edges at "
        f"N={API_N} D={KNN_D} radius {RADIUS} (one KNN launch each; indices "
        f"and masks equal to the CPU plain versions, sim max|err| "
        f"{sim_err:.3g} <= 1e-5); make_hover_typing on {N_CHECK} patches "
        f"equal to make_hover_typing_device; profiling.trace holds "
        f"{[n for n in device if 'knn_l2' in n]} and the 'knn' annotation "
        f"({len(events)} events), its spans file the span 'knn' (card "
        f"{knn_span['device_s'] * 1e3:.3f} ms, idle inside "
        f"{knn_span['card_idle_s'] * 1e3:.3f} ms of "
        f"{knn_span['host_s'] * 1e3:.3f}); {time.perf_counter() - t0:.2f} s "
        f"[{card}]")


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
    Returns the launch counts of the two constructions and where the
    slide, its tiles and its 'hover' graph are."""
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
    return total, {"slide": slide, "bag": bag,
                   "image": root / "data" / "SYN" / "tumor" / f"{slide}.jpeg",
                   "graph": root / "graphs_hover" / "heterogeneous"
                   / f"{slide}.npz"}


# ---------------------------------------------------------------------------
# explain: main.py -mode graph_explain on tile_build's slide
# ---------------------------------------------------------------------------
# the annotation traces the third tissue ellipse of write_tissue_slide
# (centre and radii as fractions of the slide's width and height)
EXPLAIN_ELLIPSE = (0.50, 0.22, 0.24, 0.18)
EXPLAIN_N = 1024            # nodes of the timed slide (cut to pay for the
                            # parallel group, PERF.md §4)
GNN_EXPLAINER_EPOCHS = 100  # the explainer's default


def write_yaml(cfg, path: Path) -> None:
    """A config of nested sections as the YAML subset config.py reads."""
    def scalar(v):
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(scalar(x) for x in v) + "]"
        return repr(v)

    def block(d, indent):
        out = []
        for k, v in d.items():
            if isinstance(v, dict):
                out.append(" " * indent + f"{k}:")
                out += block(v, indent + 2)
            else:
                out.append(" " * indent + f"{k}: {scalar(v)}")
        return out

    path.write_text("\n".join(block(cfg, 0)) + "\n")


def write_c16_layout(np, lay: Path, tiled, cfg) -> None:
    """reference.csv (the slide a Tumor), the annotation XML (a 64-point
    polygon on EXPLAIN_ELLIPSE, level-0 pixels), the eval list, and the
    config's paths pointed there. eval.patch_size 128 places 256-px
    level-0 tiles exactly: coordinates 128 * col // 2 = 64 * col at level
    2, centres 4 * 64 * col + 128 at level 0 (the reference's 256 assumes
    512-px level-0 tiles, cut at half the magnification)."""
    slide = tiled["slide"]
    (lay / "annotations").mkdir(parents=True)
    w, h = TILE_SLIDE
    cx, cy, rx, ry = EXPLAIN_ELLIPSE
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    coords = "".join(
        f'<Coordinate Order="{i}" X="{(cx + rx * np.cos(a)) * w:.2f}" '
        f'Y="{(cy + ry * np.sin(a)) * h:.2f}"/>' for i, a in enumerate(t))
    (lay / "annotations" / f"{slide}.xml").write_text(
        '<?xml version="1.0"?><ASAP_Annotations><Annotations>'
        '<Annotation Name="Tumor" Type="Polygon"><Coordinates>' + coords
        + "</Coordinates></Annotation></Annotations></ASAP_Annotations>")
    (lay / "reference.csv").write_text(f"NAME,LABEL\n{slide},Tumor\n")
    (lay / "eval.txt").write_text(f"{tiled['graph']}\n")
    cfg["datasets"].update(
        dataset="C16", patches_path=str(tiled["bag"].parent) + "/",
        wsi_path=str(tiled["image"].parent) + "/",
        eval_path=str(lay / "eval.txt"),
        reference_csv=str(lay / "reference.csv"))
    cfg["checkpoint"]["path"] = str(lay / "checkpoint")
    cfg["eval"].update(explain_path=str(lay / "plots") + "/",
                       annotation_path=str(lay / "annotations") + "/",
                       patch_size=128)


def auc_allowance(np, labels, scores, err: float) -> float:
    """The AUC change that score errors up to `err` can make: the share of
    (tumour, other) patch pairs whose scores lie within 2 err."""
    labels, scores = np.asarray(labels), np.asarray(scores)
    pos, neg = scores[labels == 1], scores[labels == 0]
    if not len(pos) or not len(neg):
        return 0.0
    close = np.abs(pos[:, None] - neg[None, :]) <= 2 * err
    return float(close.sum()) / close.size


# the comparison layout: tile columns [10, 20) x rows [3, 13) of the slide,
# across the annotation's lower edge
EXPLAIN_WINDOW = (10, 20, 3, 13)
# the checkpoint's output layer is scaled so that the tumour logit trails
# the other by 3 on the window's graph: the loss (3.05) then moves with
# every deletion, not only by f32 rounding near log 2
EXPLAIN_MARGIN = -3.0
SCORE_RTOL = 1e-4


def write_window_layout(np, lay: Path, tiled, cfg, dev):
    """The comparison layout: the tiles of EXPLAIN_WINDOW as a slide of
    their own (tile files and the slide image linked, the annotation and
    reference.csv of `cfg`'s layout), its graph built on the card from
    the 'hover' features of those tiles standardised per dimension (so
    nodes differ by O(1) in every feature, as trained features do, where
    the seeded CNN's features differ in their last digits). Returns (the
    layout's config, the slide's name)."""
    import copy
    import os

    from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz
    from wsi_hgnn_tpu_torch.graph.build import build_graph
    from wsi_hgnn_tpu_torch.pipeline.patches import list_patches

    name = tiled["slide"].replace("-DX1", "-DX2")
    c0, c1, r0, r1 = EXPLAIN_WINDOW
    keep = []
    for i, path in enumerate(list_patches(tiled["bag"])):
        col, row = (int(v) for v in path.stem.split("_")[:2])
        if c0 <= col < c1 and r0 <= row < r1:
            keep.append(i)
            (lay / "patches" / name).mkdir(parents=True, exist_ok=True)
            os.symlink(path, lay / "patches" / name / path.name)
    (lay / "wsi").mkdir()
    os.symlink(tiled["image"], lay / "wsi" / f"{name}.jpeg")
    with np.load(tiled["graph"]) as z:
        feat = z["feat"][keep].astype(np.float64)
        types = z["node_type"][keep]
    feat = ((feat - feat.mean(0)) / np.maximum(feat.std(0), 1e-6)
            ).astype(np.float32)
    het, _ = build_graph(feat, types, RADIUS, N_TYPES, knn_impl="pallas",
                         device=dev)
    n, e = len(keep), int(np.asarray(het.edge_mask).sum())
    save_graph_npz(lay / f"{name}.npz", feat, np.asarray(het.src)[:e],
                   np.asarray(het.dst)[:e], node_type=types,
                   esign=np.asarray(het.esign)[:e],
                   sim=np.asarray(het.sim)[:e], n_node_types=N_TYPES)
    (lay / "eval.txt").write_text(f"{lay / f'{name}.npz'}\n")
    ann = Path(cfg["eval"]["annotation_path"])
    os.symlink(ann / f"{tiled['slide']}.xml", ann / f"{name}.xml")
    with open(cfg["datasets"]["reference_csv"], "a") as f:
        f.write(f"{name},Tumor\n")
    win = copy.deepcopy(cfg)
    win["datasets"].update(patches_path=str(lay / "patches") + "/",
                           wsi_path=str(lay / "wsi") + "/",
                           eval_path=str(lay / "eval.txt"))
    win["eval"]["explain_path"] = str(lay / "plots") + "/"
    return win, name, n


def scores_over(np, got, want, atol: float):
    """The largest |got - want| / (SCORE_RTOL |want| + atol)."""
    return float((np.abs(got - want) / (SCORE_RTOL * np.abs(want) + atol)
                  ).max())


def explain_phase(torch, dev, card, kernels, root: Path, tiled):
    """`python -m wsi_hgnn_tpu_torch.main -mode graph_explain` (in process,
    on the card) over tile_build's slide laid out as a Camelyon16 test
    set, with configs/BRCA/HEAT4_kimia_classification.yml at its width
    (HetGemExplainer, the shipped setting) from a version-1 checkpoint of
    seeded weights, its output layer scaled (EXPLAIN_MARGIN): the AUC
    finite, both heatmaps written, a second explanation of the slide
    giving the same AUC.
    The card against the CPU on the smaller comparison layout
    (write_window_layout), ExplainGraph.eval (what main.py runs) on each:
    the scores within SCORE_RTOL relative L2 of the CPU's and, each,
    within SCORE_RTOL of it plus an atol of 2 GRAD_F32 times the f32
    rounding that randomly rounded float64 explanations show
    (gradcheck.output_spread; card and CPU each round), that atol under a
    hundredth of the median score, all-zero and sign-flipped scores
    failing the same check, the AUCs equal.
    Then timings on a seeded EXPLAIN_N-node slide graph built on the card:
    HetGemExplainer on HEAT4, GemExplainer on GCN at its BRCA width, a
    100-step GNNExplainer on HEAT4; ms per slide, peak memory, and the
    device busy share of the 586-node explanation. Returns the launch
    counts of the phase."""
    import copy

    import numpy as np

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import load_config, parse_gnn_model
    from wsi_hgnn_tpu_torch.data.datasets import load_graph_npz
    from wsi_hgnn_tpu_torch.explain import (ExplainGraph, GemExplainer,
                                            GNNExplainer, HetGemExplainer)
    from wsi_hgnn_tpu_torch.graph.build import build_batch_device
    from wsi_hgnn_tpu_torch.graph.typed_graph import to_homogeneous
    from wsi_hgnn_tpu_torch.main import main as port_main
    from wsi_hgnn_tpu_torch.train import gradcheck
    from wsi_hgnn_tpu_torch.train.checkpoint import CheckpointManager
    from wsi_hgnn_tpu_torch.train.metrics import binary_auc_from_scores
    from wsi_hgnn_tpu_torch.utils import to_torch

    t_phase = time.perf_counter()
    slide, lay = tiled["slide"], root / "c16"
    cfg = load_config(ROOT / HEAT4_CONFIG)
    write_c16_layout(np, lay, tiled, cfg)
    g = cfg["GNN"]
    check(cfg["eval"]["explainer_name"] == "GemExplainer"
          and g["name"] == "HEAT4" and g["in_dim"] == 1024
          and g["hidden_dim"] == 512 and g["n_heads"] == 4
          and g["num_layers"] == 2 and g["n_node_types"] == N_TYPES,
          f"{HEAT4_CONFIG} is not the config this phase states: {g}")
    knn0 = kernels.launch_counts()["knn_l2_fused"]
    win_cfg, win, n_win = write_window_layout(np, lay / "window", tiled, cfg,
                                              dev)
    check(kernels.launch_counts()["knn_l2_fused"] - knn0 == 1,
          "the comparison graph was not built by the KNN kernel")
    model, _ = parse_gnn_model(g)
    convert.init_flax_like_(model, 9).eval()
    g_win = load_graph_npz(lay / "window" / f"{win}.npz").to_torch(
        torch.device("cpu"))
    with torch.no_grad():
        z = model(g_win.replace(esign=torch.ones_like(g_win.esign)))[0]
        scale = EXPLAIN_MARGIN / float(z[1] - z[0])
        model.head.weight.mul_(scale)
        model.head.bias.mul_(scale)
    variables = convert.to_flax_variables(model)
    CheckpointManager(cfg["checkpoint"]["path"]).write_new_version(
        cfg, {"params": variables["params"], "batch_stats": {}}, {"Epoch": 1})
    write_yaml(cfg, lay / "explain.yml")

    # ---- the main path: counters from 0 -------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    aucs = port_main(["-config", str(lay / "explain.yml"), "-mode",
                      "graph_explain"])
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plots = [lay / "plots" / f"{slide}{ext}" for ext in (".png", ".jpeg")]
    check(len(aucs) == 1 and np.isfinite(aucs[0]),
          f"graph_explain AUCs {aucs}: want one finite")
    check(all(p.is_file() and p.stat().st_size for p in plots),
          f"heatmaps not written: {plots}")
    eg = ExplainGraph(cfg, device=dev)
    graph, _, label = eg.eval_data[0]
    g_dev = graph.to_torch(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_main = eg.explain_one(g_dev, label)
    torch.cuda.synchronize()
    slide_ms = (time.perf_counter() - t0) * 1e3
    coords = eg.get_patch_coords(slide)
    labels, _ = eg.get_ground_truths(eg.eval_data.xml_paths[0], coords)
    check(len(coords) == graph.node_mask.sum() == len(s_main),
          f"{len(coords)} patches, {int(graph.node_mask.sum())} nodes, "
          f"{len(s_main)} scores")

    # ---- the card against the CPU on the comparison layout ------------
    cpu_cfg = copy.deepcopy(win_cfg)
    cpu_cfg["GNN"]["typed_impl"] = "ragged"   # the same function
    cpu_cfg["eval"]["explain_path"] = str(lay / "window" / "plots_cpu") + "/"
    runs = []
    for where, c in ((dev, win_cfg), (torch.device("cpu"), cpu_cfg)):
        t0 = time.perf_counter()
        e = ExplainGraph(c, device=where)
        runs.append((e.eval(), e.last_scores[win],
                     time.perf_counter() - t0, e))
    (auc_dev, s_dev, t_dev, e_dev), (auc_cpu, s_cpu, t_cpu, _) = runs
    # f32 rounding of a score, from randomly rounded float64 explanations
    # of the window on the card; card and CPU each round
    m64 = copy.deepcopy(e_dev.model).double()
    g64 = g_win.to_torch(dev)
    g64 = g64.replace(feat=g64.feat.double(), sim=g64.sim.double())

    def explain64():
        return HetGemExplainer(g64, m64, 1).flat_scores()

    t0 = time.perf_counter()
    with gradcheck.float64_default():
        s64 = explain64()
    spread = gradcheck.output_spread(explain64, s64, device=dev)
    t64 = time.perf_counter() - t0
    atol = 2 * gradcheck.GRAD_F32 * spread
    typical = float(np.median(np.abs(s_cpu)))
    over = scores_over(np, s_dev, s_cpu, atol)
    over_zero = scores_over(np, np.zeros_like(s_cpu), s_cpu, atol)
    over_flip = scores_over(np, -s_cpu, s_cpu, atol)
    rel = float(np.linalg.norm(s_dev - s_cpu) / np.linalg.norm(s_cpu))
    err = float(np.abs(s_dev - s_cpu).max())
    w_coords = e_dev.get_patch_coords(win)
    w_labels, _ = e_dev.get_ground_truths(e_dev.eval_data.xml_paths[0],
                                          w_coords)
    allow = auc_allowance(np, w_labels, s_cpu, err)
    check(len(s_cpu) == len(s_dev) == n_win == len(w_coords),
          f"{len(s_cpu)} CPU and {len(s_dev)} card scores, {n_win} nodes")
    check(0 < atol <= 1e-2 * typical, f"atol {atol} is not small next to "
          f"the median score {typical}: the check could not fail wrong "
          f"scores")
    check(over_zero > 1.0 and over_flip > 1.0,
          f"zero scores ({over_zero}) or sign-flipped scores ({over_flip}) "
          f"pass the score check")
    check(rel <= SCORE_RTOL and over <= 1.0,
          f"card HetGEM scores vs CPU: rel L2 {rel}, largest error over "
          f"rtol {SCORE_RTOL:g} + atol {atol:.3g} is {over} (max abs {err})")
    check(0 < sum(w_labels) < len(w_labels)
          and abs(auc_dev[0] - auc_cpu[0]) <= allow,
          f"pixel AUC {auc_dev[0]} on the card, {auc_cpu[0]} on the CPU "
          f"(allowance {allow}; {sum(w_labels)} of {len(w_labels)} patches "
          f"inside the annotation)")
    log(f"explain ({HEAT4_CONFIG}: HEAT4 in 1024 hidden 512 heads 4 layers "
        f"2, seeded version-1 checkpoint, output layer x {scale:.6g}; "
        f"HetGemExplainer): main.py -mode graph_explain on {slide} "
        f"({len(coords)} patches, {int(sum(labels))} inside the annotation) "
        f"in {t_main:.2f} s: pixel AUC {aucs[0]:.6f}, heatmaps "
        f"{[p.name for p in plots]}; launches {launches} [{card}]")
    c0, c1, r0, r1 = EXPLAIN_WINDOW
    log(f"explain card vs CPU (ExplainGraph.eval on {win}: tile columns "
        f"{c0}-{c1 - 1} x rows {r0}-{r1 - 1} of the slide, {n_win} nodes, "
        f"{sum(w_labels)} inside the annotation, standardised 'hover' "
        f"features, graph built on the card): pixel AUC {auc_dev[0]:.6f} "
        f"on the card in {t_dev:.2f} s, {auc_cpu[0]:.6f} on the CPU in "
        f"{t_cpu:.2f} s (|diff| <= {allow:.3g}); median |score| "
        f"{typical:.4g}; scores card vs CPU: rel L2 {rel:.3g} (<= "
        f"{SCORE_RTOL:g}), max abs {err:.3g}, card vs float64 max abs "
        f"{float(np.abs(s_dev - s64).max()):.3g}, CPU vs float64 "
        f"{float(np.abs(s_cpu - s64).max()):.3g}; largest error over rtol "
        f"{SCORE_RTOL:g} + atol {atol:.3g} (2 x {gradcheck.GRAD_F32:g} x "
        f"{spread:.3g}, the largest change {gradcheck.DRAWS} randomly "
        f"rounded float64 explanations on the card made, {t64:.2f} s; "
        f"{atol / typical:.3g} of the median score) {over:.3g} (<= 1); "
        f"the same check on all-zero scores {over_zero:.4g}, on "
        f"sign-flipped scores {over_flip:.4g} (both must exceed 1) [{card}]")

    # ---- timings on an EXPLAIN_N-node slide -----------------------------
    rng = np.random.RandomState(31)
    feat = rng.randn(1, EXPLAIN_N, 1024).astype(np.float32)
    types = rng.randint(0, N_TYPES, (1, EXPLAIN_N))
    real = torch.ones(1, EXPLAIN_N, dtype=torch.bool, device=dev)
    knn0 = kernels.launch_counts()["knn_l2_fused"]
    typed = build_batch_device(to_torch(feat, dev), to_torch(types, dev),
                               real, RADIUS, N_TYPES)
    homo = to_homogeneous(build_batch_device(
        to_torch(feat, dev), to_torch(types, dev), real, RADIUS, N_TYPES,
        add_self_loops=True))
    check(kernels.launch_counts()["knn_l2_fused"] - knn0 == 2,
          "the timed slide's graphs were not built by the KNN kernel")
    gcn, _ = parse_gnn_model(load_config(
        ROOT / "configs/BRCA/GCN_kimia_classification.yml")["GNN"])
    gcn = convert.init_flax_like_(gcn, 4).to(dev).eval()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) * 1e3,
                torch.cuda.max_memory_allocated() / 2 ** 30, out)

    rows = {
        "HetGemExplainer, HEAT4": timed(lambda: HetGemExplainer(
            typed, eg._model_fn, 1).flat_scores()),
        "GemExplainer, GCN (BRCA: in 1024 hidden 256 layers 3)": timed(
            lambda: GemExplainer(homo, lambda x: gcn(x), 1).explain_node()),
        f"GNNExplainer ({GNN_EXPLAINER_EPOCHS} Adam steps), HEAT4": timed(
            lambda: GNNExplainer(typed, eg._model_fn, 1,
                                 epochs=GNN_EXPLAINER_EPOCHS,
                                 model=eg.model).explain_node(None)[1]),
    }
    for name, (ms, gib, out) in rows.items():
        check(np.isfinite(out).all() and len(out) == EXPLAIN_N,
              f"{name}: {len(out)} scores, finite {np.isfinite(out).all()}")
    again = []
    busy = profile_span(torch, lambda: again.append(eg.explain_one(g_dev,
                                                                   label)),
                        f"HetGemExplainer on {slide} ({len(coords)} nodes)",
                        card, top=6)
    # main.py's AUC against the timed explanation's: equal but for the
    # (tumour, other) pairs whose scores lie within what two runs on the
    # card differ by (index_add_'s atomics sum in any order)
    noise = float(np.abs(again[0] - s_main).max())
    auc_main = binary_auc_from_scores(np.asarray(labels), s_main)
    check(abs(auc_main - aucs[0]) <= auc_allowance(np, labels, s_main, noise),
          f"main.py's AUC {aucs[0]} and the card's second explanation's "
          f"{auc_main} differ by more than the pairs within twice the "
          f"run-to-run score difference {noise} can swap")
    log(f"explain: the card's second and third explanations of {slide} "
        f"differ by up to {noise:.3g} (median |score| "
        f"{float(np.median(np.abs(s_main))):.4g}); AUC {auc_main:.6f} against "
        f"main.py's {aucs[0]:.6f} [{card}]")
    log(f"timing explain: {slide_ms:.1f} ms for the {len(coords)}-node slide "
        f"(HetGemExplainer, HEAT4), peak device memory of main.py's run "
        f"{peak:.2f} GiB, device busy share "
        + ("not measured" if busy is None else f"{busy:.3f}")
        + f"; on a seeded {EXPLAIN_N}-node slide (KNN graph built on the "
        "card): " + "; ".join(f"{name} {ms:.1f} ms, peak {gib:.2f} GiB"
                              for name, (ms, gib, _) in rows.items())
        + f" [{card}]")
    log(f"explain phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# parallel group: the featurizer's data parallelism, edge sharding and the
# data-parallel step, on one card
# ---------------------------------------------------------------------------
PAR_PATCHES = 130      # one chunk: padded to 256 (2 x 128) over 2 devices
PAR_DEVICES = 2        # the device list repeats the one card
PAR_FEAT_RTOL = 1e-3   # relative L2 of sharded against single-device features
BF16_FEAT_RTOL = 0.1   # bf16 features against another batch's (PERF.md §2)
PAR_NODES = 1024       # nodes of each of the two slides of the rank steps
PAR_WORLD = 2          # gloo ranks, both on the one card
GCN_CONFIG = "configs/BRCA/GCN_kimia_classification.yml"


def _par_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank of the gloo world (spawned; both ranks on the one card): the
    edge-sharded HEAT4 and GCN steps on this rank's half of the two
    slides' edge store, then the data-parallel GCN step on this rank's
    slide. Writes each step's loss and gradients for the parent."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import parse_gnn_model, parse_loss
    from wsi_hgnn_tpu_torch.graph.typed_graph import TypedGraph
    from wsi_hgnn_tpu_torch.parallel import (local_edges,
                                             make_big_graph_train_step,
                                             make_dp_train_step, make_mesh,
                                             place_state, rank_generator)
    from wsi_hgnn_tpu_torch.utils import set_cuda_numerics

    # the inputs from a file: through the spawn pipe the parent would feed
    # one rank at a time, each only after it imported torch
    with open(Path(out_dir) / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    t0 = time.perf_counter()
    times = {"start": time.time() - inp["spawned"]}   # process and imports
    torch.set_num_threads(2)    # the host work is small; the parent runs
    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        set_cuda_numerics()
        torch.ones(1, device=dev).sum().item()   # the CUDA context
    times["cuda init"] = time.perf_counter() - t0
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    times["group"] = time.perf_counter() - t0 - times["cuda init"]
    try:
        mesh = make_mesh(device=dev)
        loss_fcn = parse_loss({"loss": "CE"})
        labels = torch.tensor(inp["labels"], device=dev)
        weights = torch.ones(len(inp["labels"]), device=dev)
        out = {}

        def lap(what):
            times[what] = (time.perf_counter() - t0 - sum(times.values())
                           + times["start"])

        def trained(name):
            model, hetero = parse_gnn_model(inp["gnn"][name])
            convert.load_flax_variables(model, inp["variables"][name])
            model.to(dev)
            return model, hetero, torch.optim.SGD(model.parameters(), lr=1e-3)

        def grads(model):
            return {n: p.grad.cpu().numpy() for n, p in
                    model.named_parameters()}

        for name in ("HEAT4", "GCN"):
            model, hetero, opt = trained(name)   # a first optimizer
            lap(f"{name} model")                  # imports torch._dynamo
            step = make_big_graph_train_step(model, opt, loss_fcn, hetero,
                                             mesh, augment=False)
            loss, _ = step(local_edges(TypedGraph(**inp["graph"]), mesh),
                           labels, weights,
                           torch.Generator(device=dev).manual_seed(0))
            out[name] = (float(loss), grads(model))
            lap(f"{name} step")
        model, hetero, opt = trained("GCN")
        place_state(model, opt, mesh)
        step = make_dp_train_step(model, opt, loss_fcn, hetero, mesh,
                                  augment=False)
        loss, _ = step(TypedGraph(**inp["slides"][rank]).to_torch(dev),
                       labels[rank:rank + 1], weights[rank:rank + 1],
                       rank_generator(0, mesh))
        out["dp"] = (float(loss), grads(model))
        lap("dp step")
        out["times"] = {k: round(v, 2) for k, v in times.items()}
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _host(g):
    """A device TypedGraph's arrays on the host, as TypedGraph kwargs."""
    arrays = {f: getattr(g, f).cpu().numpy() for f in (
        "feat", "node_type", "node_graph", "node_mask", "src", "dst",
        "esign", "sim", "edge_mask")}
    return dict(arrays, n_graphs=g.n_graphs, n_node_types=g.n_node_types,
                n_edge_types=g.n_edge_types)


def _slide_of(g, r: int, n: int):
    """Slide r of a build_batch_device batch of equal slides (nodes and
    src-major edges contiguous per slide), as a one-slide graph."""
    arrays = _host(g)
    e = arrays["src"].shape[0] // g.n_graphs
    nodes, edges = slice(r * n, (r + 1) * n), slice(r * e, (r + 1) * e)
    out = {k: arrays[k][nodes] for k in ("feat", "node_type", "node_mask")}
    out.update({k: arrays[k][edges] for k in ("esign", "sim", "edge_mask")})
    out.update(src=arrays["src"][edges] - r * n, dst=arrays["dst"][edges] - r * n,
               node_graph=arrays["node_graph"][nodes] * 0)
    return dict(out, n_graphs=1, n_node_types=g.n_node_types,
                n_edge_types=g.n_edge_types)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class SingleCardStep:
    """The single-card step of `model` on `g` (f32 and float64 gradients,
    the float64 spread drawn once, when first needed) against which
    sharded steps' gradients are judged: relative L2 1e-4 per tensor, or
    the float64 judge (wsi_hgnn_tpu_torch/train/gradcheck.py)."""

    def __init__(self, torch, dev, model, g, labels):
        import copy

        from wsi_hgnn_tpu_torch.config import parse_loss

        self.torch, self.dev, self.g, self.labels = torch, dev, g, labels
        self.loss_fcn = parse_loss({"loss": "CE"})
        self.names = [n for n, _ in model.named_parameters()]
        self.base64 = copy.deepcopy(model).double()
        self.ref = copy.deepcopy(model)
        self._run(self.ref, g)
        self.m64 = copy.deepcopy(self.base64).to(dev)
        self.run64(self.m64)
        self.g64 = {n: p.grad.detach().double().cpu() for n, p in
                    self.m64.named_parameters()}
        self._spread = None

    def _run(self, m, graph):
        m.train()
        m.zero_grad(set_to_none=False)
        w = self.torch.ones(self.labels.shape[0], dtype=graph.feat.dtype,
                            device=graph.feat.device)
        self.loss_fcn(m(graph), self.labels.to(graph.feat.device),
                      w).backward()

    def run64(self, m):
        self._run(m, self.g.replace(feat=self.g.feat.double(),
                                    sim=self.g.sim.double()))

    def spread(self):
        from wsi_hgnn_tpu_torch.train import gradcheck

        if self._spread is None:
            self._spread = gradcheck.rounding_spread(
                self.run64, self.base64, self.g64, device=self.dev)
        return self._spread

    def judge(self, got, what: str) -> str:
        """`got` (name -> gradient) judged; fails the group on any tensor
        the judge fails. Returns the judge's log fragment."""
        import types

        from wsi_hgnn_tpu_torch.train import gradcheck

        named_got = [(n, types.SimpleNamespace(
            grad=self.torch.as_tensor(got[n]), requires_grad=True))
            for n in self.names]
        text, failed = gradcheck.judge(
            list(self.ref.named_parameters()), named_got,
            list(self.m64.named_parameters()), self.spread)
        check(not failed, f"{what}: gradients differ from the single-card "
              f"step: {failed} ({text})")
        return text


def parallel_phase(torch, dev, card, kernels, root: Path,
                   patches=PAR_PATCHES, nodes=PAR_NODES, gnn=None,
                   hover_dim=1024):
    """(a) The featurizer's data parallelism: the 'kimia' (with HoVer-Net
    typing) and 'hover' encoders sharded over [card, card] on a chunk of
    130 patches (padded to 256, 128 a device) against the single-device
    encoder on the same card and weights, and the slide graph built from
    the sharded features; (b) a gloo world of 2 ranks on the card: the
    edge-sharded HEAT4 and GCN steps and the data-parallel GCN step
    against the single-card step; (c) an NCCL world of 1: the edge-sharded
    step against the plain one. The world's processes start first and run
    beside the rest. Counters are zeroed before the rank steps' graphs
    are built and before the sharded encoders, and read after each: the
    group's main path. Returns
    those launch counts. `gnn` (GNN widths) and `hover_dim` (HoVer-Net's
    fc1 width) shrink a CPU rehearsal."""
    import math
    import pickle

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import (load_config, parse_gnn_model,
                                           parse_loss)
    from wsi_hgnn_tpu_torch.graph.build import build_batch_device, build_graph
    from wsi_hgnn_tpu_torch.graph.typed_graph import (TypedGraph,
                                                      to_homogeneous)
    from wsi_hgnn_tpu_torch.models.featurizers import (HoVerNet, KimiaNet,
                                                       _pad_rows,
                                                       load_cnn_variables,
                                                       make_cnn_encoder)
    from wsi_hgnn_tpu_torch.parallel import (local_edges,
                                             make_big_graph_train_step,
                                             make_mesh)

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    # ---- (b) a gloo world of 2 ranks on the card, started first: it runs
    # while the parent does (a), the references and (c) ---------------------
    t0 = time.perf_counter()
    heat = dict(GNN, feat_drop=0.0, **(gnn or {}))
    # the BRCA GCN with its attention pooling: the gate's bias has a
    # gradient of about 0, which only the float64 judge's randomly rounded
    # steps can judge
    gcn_cfg = dict(load_config(ROOT / GCN_CONFIG)["GNN"], dropout=0.0,
                   feat_drop=0.0, **(gnn or {}))
    rng = np.random.RandomState(91)
    in_dim = heat["in_dim"]
    kernels.reset_launch_counts()
    feats = torch.from_numpy(rng.randn(2, nodes, in_dim).astype(np.float32))
    types = torch.from_numpy(rng.randint(0, N_TYPES, (2, nodes)))
    g = build_batch_device(feats.to(dev), types.to(dev),
                           torch.ones((2, nodes), dtype=torch.bool,
                                      device=dev), RADIUS, N_TYPES)
    launches_b = kernels.launch_counts()
    check(launches_b == {"knn_l2_fused": 2, "dense_layer_fused": 0,
                         "transition_fused": 0},
          f"the rank steps' graphs launched {launches_b}")
    labels = np.array([0, 1])
    models, variables = {}, {}
    for name, spec, seed in (("HEAT4", heat, 5), ("GCN", gcn_cfg, 6)):
        m, _ = parse_gnn_model(spec)
        convert.init_flax_like_(m, seed)
        variables[name] = convert.to_flax_variables(m)
        models[name] = m.to(dev)
    inp = {"device": str(dev), "gnn": {"HEAT4": heat, "GCN": gcn_cfg},
           "variables": variables,
           "graph": _host(g), "labels": labels,
           "slides": [_slide_of(g, r, nodes) for r in range(PAR_WORLD)]}
    world_dir = root / "world"
    world_dir.mkdir()
    inp["spawned"] = time.time()
    with open(world_dir / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f, protocol=pickle.HIGHEST_PROTOCOL)
    world = mp.spawn(_par_rank, args=(PAR_WORLD, f"tcp://127.0.0.1:"
                                      f"{free_port()}", str(world_dir)),
                     nprocs=PAR_WORLD, join=False)
    try:
        # (a), the single-card references and (c) while the ranks work
        t0 = time.perf_counter()
        cfg = {"feature_dim": hover_dim, "n_node_type": N_TYPES}
        width = {"kimia": 1024, "hover": hover_dim}
        hcfg = {"mode": "fast", "batch_size": CHUNK}
        kimia = load_cnn_variables("kimia", KimiaNet(), None, 1)
        typing = load_cnn_variables("hover", HoVerNet.typing(N_TYPES, "fast"),
                                    None, 0, N_TYPES)
        with torch.device("meta"):
            full = HoVerNet(N_TYPES, "fast", feat_dim=cfg["feature_dim"])
        hover = load_cnn_variables("hover", full, None, 0, N_TYPES)
        px = patch_pool(patches, seed=90)
        devices = [dev] * PAR_DEVICES
        encoders = {}
        for name, hv in (("kimia", typing), ("hover", hover)):
            for sharded in (True, False):
                encoders[name, sharded] = make_cnn_encoder(
                    name, cfg, hcfg, {}, with_typing=name == "kimia",
                    pad_batch_to=CHUNK, device=dev,
                    devices=devices if sharded else None,
                    kimia_variables=kimia, hover_variables=hv)
        t_setup = time.perf_counter() - t0
        # ---- (a) the main path: counters from 0 -----------------------------
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t_a0 = time.perf_counter()
        got = {name: encoders[name, True](px) for name in ("kimia", "hover")}
        het, _ = build_graph(got["kimia"][0], got["kimia"][1], radius=RADIUS,
                             n_node_types=N_TYPES, knn_impl="pallas", device=dev)
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t_a0
        launches_a = kernels.launch_counts()
        # one chunk, split into one part a device: each part is one batch of
        # the DenseNet kernels; one KNN for the slide graph
        want_a = {"knn_l2_fused": 1,
                  **{k: v * PAR_DEVICES for k, v in PER_CHUNK.items()}}
        check(launches_a == want_a, f"sharded encoders and graph launched "
              f"{launches_a}, want {want_a}")
        check(int(np.asarray(het.node_mask).sum()) == patches,
              "graph of the sharded features")
        # the single-device encoder on the same per-device batches (the chunk
        # padded as the sharded encoder pads it, run half by half: the same
        # cuDNN algorithms, so bf16 rounds alike), and on the whole chunk
        # (another batch: bf16 products round differently, held to the bf16
        # bound of the served features)
        padded = _pad_rows(_pad_rows(px, CHUNK), PAR_DEVICES)
        per = len(padded) // PAR_DEVICES
        errs = []
        for name in ("kimia", "hover"):
            single = encoders[name, False]
            halves = [single(padded[i * per:(i + 1) * per])
                      for i in range(PAR_DEVICES)]
            want_f = np.concatenate([h[0] for h in halves])[:patches]
            want_t = np.concatenate([h[1] for h in halves])[:patches]
            f, t = got[name]
            check(f.shape == (patches, width[name]) and np.all(
                np.isfinite(f)), f"{name}: sharded features {f.shape}")
            rel = float(np.linalg.norm(f - want_f) / np.linalg.norm(want_f))
            check(rel <= PAR_FEAT_RTOL, f"{name}: sharded features {rel:.3g} "
                  f"relative L2 from the single-device encoder's on the same "
                  f"batches (> {PAR_FEAT_RTOL})")
            check(np.array_equal(t, want_t), f"{name}: sharded node types "
                  "differ from the single-device encoder's")
            whole_f, whole_t = single(px)
            rel_whole = float(np.linalg.norm(f - whole_f)
                              / np.linalg.norm(whole_f))
            check(rel_whole <= BF16_FEAT_RTOL, f"{name}: sharded features "
                  f"{rel_whole:.3g} relative L2 from the single-device encoder's "
                  f"on the whole chunk (> {BF16_FEAT_RTOL})")
            errs.append(f"{name} rel L2 {rel:.3g} on the same batches, "
                        f"{rel_whole:.3g} against the whole chunk (types "
                        f"{int((t == whole_t).sum())}/{patches} equal)")
        log(f"parallel (a): 'kimia'+typing and 'hover' encoders sharded over "
            f"{PAR_DEVICES} x {dev} on {patches} patches (padded to "
            f"{len(padded)}, {per} a device), then the slide graph, in "
            f"{t_sharded * 1e3:.1f} ms; against the single-device encoders: "
            f"{'; '.join(errs)} (<= {PAR_FEAT_RTOL} and {BF16_FEAT_RTOL}), "
            f"node types equal on the same batches; launches {launches_a} "
            f"[{card}]")
        t_a = time.perf_counter() - t_a0
        # the single-card references and (c), while the ranks work
        y = torch.tensor(labels, device=dev)
        single = {"HEAT4": SingleCardStep(torch, dev, models["HEAT4"], g, y),
                  "GCN": SingleCardStep(torch, dev, models["GCN"],
                                        to_homogeneous(g), y)}

        # ---- (c) an NCCL world of 1 ---------------------------------------
        cuda = dev.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1,
                                device_id=dev if cuda else None)
        try:
            model, _ = parse_gnn_model(heat)
            convert.load_flax_variables(model, variables["HEAT4"])
            model.to(dev)
            step = make_big_graph_train_step(
                model, torch.optim.SGD(model.parameters(), lr=1e-3),
                parse_loss({"loss": "CE"}), True, make_mesh(device=dev),
                augment=False)
            host = TypedGraph(**inp["graph"])
            loss, _ = step(local_edges(host, make_mesh(device=dev)), y,
                           torch.ones(2, device=dev),
                           torch.Generator(device=dev).manual_seed(0))
            grads = {n: p.grad.cpu().numpy() for n, p in
                     model.named_parameters()}
        finally:
            dist.destroy_process_group()
        text = single["HEAT4"].judge(grads, "NCCL world of 1")
        log(f"parallel (c): NCCL world of 1, the edge-sharded HEAT4 step "
            f"(loss {float(loss):.6f}) against the plain step: {text} "
            f"[{card}]")
        t_c = time.perf_counter() - t_a0 - t_a
        # ---- (b) continued: the ranks' results ----------------------------
        t_wait = time.perf_counter()
        while not world.join():
            pass
        t_wait = time.perf_counter() - t_wait
    finally:
        for proc in world.processes:   # (a) failed: stop the ranks
            if proc.is_alive():
                proc.terminate()
            proc.join()

    ranks = []
    for r in range(PAR_WORLD):
        with open(world_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    t_judge = time.perf_counter()
    texts = []
    for name, key in (("HEAT4", "HEAT4"), ("GCN", "GCN"), ("GCN", "dp")):
        losses = [r[key][0] for r in ranks]
        # replicated node work sums with atomics on the card: the ranks'
        # losses agree to f32 rounding, not bit for bit
        check(all(math.isfinite(x) for x in losses)
              and max(losses) - min(losses) <= 1e-5 * abs(losses[0]),
              f"{key}: rank losses {losses} (relative 1e-5)")
        for r in range(PAR_WORLD):
            texts.append(f"{key} rank {r}: " + single[name].judge(
                ranks[r][key][1], f"{key} rank {r}"))
    t_judge = time.perf_counter() - t_judge
    log(f"parallel (b): gloo world of {PAR_WORLD} on {dev}: edge-sharded HEAT4 "
        f"(in {heat['in_dim']}, hidden {heat['hidden_dim']}) and GCN "
        f"(hidden {gcn_cfg['hidden_dim']}, {gcn_cfg['num_layers']} layers) "
        f"steps on 2 slides x {nodes} nodes ({g.num_edges} edge slots, "
        f"{g.num_edges // PAR_WORLD} a rank), the DP GCN step one slide a "
        f"rank, each against the single-card step: " + "; ".join(texts)
        + f" [{card}]")

    log(f"timing parallel: set-up {t_setup:.1f} s, sharded encoders + graph "
        f"{t_sharded * 1e3:.1f} ms, (a) with its references {t_a:.1f} s, "
        f"the single-card references and (c) {t_c:.1f} s, the gloo world's "
        f"wait after them {t_wait:.1f} s (rank 0, s: {ranks[0]['times']}), "
        f"the judge {t_judge:.1f} s [{card}]")
    total = {k: launches_a[k] + launches_b[k] for k in launches_a}
    return [total]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v for every kernel")
    ap.add_argument("--f32-timing", action="store_true",
                    help="build, then only check and time the f32 dense "
                         "layer and transition at B = 128, SimCLR's f32 "
                         "backbone and mma.sync's peak rates (an A/B of two "
                         "trees runs this script in each); prints no result "
                         "lines")
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

    t_start = time.perf_counter()
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
    # an older tree (the A/B's parent) has the bf16 query only
    if hasattr(dn, "occupancy"):
        for name in ("dense_layer", "transition"):
            for dtype in (torch.bfloat16, torch.float32):
                blocks, smem = dn.occupancy(name, dtype)
                log(f"{name} {dtype} kernel: {blocks} block(s) of 256 "
                    f"threads per SM, {smem} bytes of shared memory per "
                    f"block [{card}]")
    set_cuda_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    gen_dev = torch.Generator(device=dev).manual_seed(0)
    if args.f32_timing:
        t0 = time.perf_counter()
        f32_kernel_timing(torch, dn, dev, gen_dev, card)
        backbone_f32_timing(torch, dev, card)
        if (ROOT / "wsi_hgnn_tpu_torch" / "csrc" / "mma_rate.cu").exists():
            mma_rate(torch, dev, card)
        log_hold(card)
        log(f"chip_smoke: f32 timing took {time.perf_counter() - t0:.1f} s "
            f"(in {ROOT})")
        return 0

    results = {}
    results["knn_l2_fused"] = knn_phase(torch, kn, knn_ops, dev, gen, card)
    results["dense_layer_fused"] = dense_phase(torch, dn, dev, gen_dev, card)
    results["transition_fused"] = transition_phase(torch, dn, dev, gen_dev,
                                                   card)
    for name, r in results.items():
        log(f"timing {name}: {r['ms']:.4g} ms/launch (bound {r['bound_ms']:.4g}"
            f" ms by {r['bound_by']}; plain {r['plain_ms']:.4g} ms; "
            f"host-issued events {r['issued_ms']:.4g} ms) [{card}]")
    log_hold(card)

    # four independent groups of phases: a failed check ends its group,
    # is reported, and the run goes on to the next group; any failure
    # fails the run (exit 1, no result lines)
    failures, counts = [], []

    def serving(root):
        served, pred = slice_phase(torch, dev, card, kernels, root)
        return served, server_phase(torch, dev, card, kernels, pred)

    def training(root):
        trained, splits = train_phase(torch, dev, card, kernels, root)
        return (trained, zoo_phase(torch, dev, card, kernels, root, splits),
                mil_phase(torch, dev, card, kernels, root, splits),
                mil_tree_phase(torch, dev, card, kernels, root, dn, gen_dev))

    def parallel(root):
        return parallel_phase(torch, dev, card, kernels, root)

    def building(root):
        constructed = construct_phase(torch, dev, card, kernels, root)
        tiled, layout = tile_build_phase(torch, dev, card, kernels, root)
        return (constructed, tiled, explain_phase(
            torch, dev, card, kernels, root, layout))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, group in (
                ("serving", serving),
                ("construction", building),
                ("training", training),
                ("parallel", parallel)):
            root = Path(tmp) / name
            root.mkdir()
            t0 = time.perf_counter()
            try:
                counts += group(root)
                log(f"{name} phases took {time.perf_counter() - t0:.1f} s")
            except CheckFailed as e:
                failures.append(f"{name}: {e}")
                log(f"chip_smoke: {name} phases FAILED: {e}")
    if failures:
        raise CheckFailed("; ".join(failures))
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")

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
