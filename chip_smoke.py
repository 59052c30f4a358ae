#!/usr/bin/env python3
"""Kernel bench of the PyTorch port (`wsi_hgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, one card, exit 0 when all holds
    python3 chip_smoke.py --f32-timing   # only the f32 kernels at B = 128,
                                         # the f32 backbone, mma.sync's rates

1. Prints the card (`nvidia-smi` name and power limit) and builds every
   CUDA kernel from `wsi_hgnn_tpu_torch/csrc` with nvcc for sm_90a, one
   nvcc per source, all at once; prints the DenseNet kernels' blocks per
   SM and shared memory, bf16 and f32 (`--ptxas` adds nvcc's register
   report).
2. Kernel phases: each kernel against its plain PyTorch version at the
   main path's shapes, the tolerance printed beside the error (the bf16
   dense layer at all 58 layers of a 128-patch chunk; the KNN bit-equal
   on exact, ragged, tiny and all-ties slides and at N = 384 .. 16384;
   `bn_act` bit-equal in its three forms at a chunk's d0-d3 maps;
   UNI2-h's `swiglu` and `add_layer_norm` bit-equal at a 256-patch
   chunk's rows); HoVer-Net typing of a chunk timed four ways (bn_act or
   the plain ops, convolutions padding themselves or tf_same_pad copies)
   and a UNI2-h chunk with the kernels and with the plain ops.
3. Timing lines, one per main-path shape (each KNN size, dense block,
   transition, bn_act map, swiglu and add_layer_norm form; the f32 dense
   layer and transition at SimCLR's B = 128 against the f32 and 3xTF32
   bounds): ms/launch, bound and share of the bound. Kernel times are
   card-bound (`cuda_ms`): a torch.cuda._sleep holds the card while the
   host issues the timed calls, and start.query() says whether the host
   was late (then the batch is timed again); each line also prints the
   host-issued timing (`issued_ms`), and one line counts the held and
   late batches.
4. The two pixel paths the benchmark serves, launch counters zeroed
   just before and read just after: `SlidePredictor` at the width of
   configs/BRCA/HEAT4_kimia_classification.yml from pixels (KimiaNet
   features + HoVer-Net typing, bf16, exact KNN, lattice HEAT4) on
   requests of 2048, 1000 and 300 patches, answers held against plain
   references on small inputs; then the uni2h-serve-pixels path, the
   GAT of configs/BRCA/GAT_kimia_classification.yml at in_dim 1536 on
   seeded UNI2-h in chunks of 256, one UNI2H_N-patch request (24
   `swiglu` and 49 `add_layer_norm` launches a chunk, one KNN, nothing
   of HoVer-Net's or KimiaNet's), its features against the plain ops'.

The end-to-end paths are held on the card by the `gpu` tests
(tests/test_torch_gpu.py) and timed by the benchmark (benchmark/).

The line before the last is the kernels JSON (launches summed over the
two pixel paths' requests), the last line the device JSON. Any failed
check exits non-zero. Imports nothing of JAX.
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


# HoVer-Net's residual block outputs of a chunk: (H, C) at d0, d1, d2, d3
BN_ACT_MAPS = ((256, 256), (128, 512), (64, 1024), (32, 2048))
BN_ACT_FORMS = (("relu(bn(x))", False, False), ("sum kept", True, True),
                ("sum dropped", True, False))   # (form, residual, keep_sum)
HOVER_REPS = 3      # timed typing forwards of a chunk per variant


def _pad_copy_route(torch, thv, model):
    """A copy of the typing net whose self-padding convolutions pad with
    tf_same_pad copies first, as the net ran before they padded
    themselves (the yardstick for the pads; the port never runs it)."""
    import copy

    class PadThenConv(torch.nn.Module):
        def __init__(self, conv):
            super().__init__()
            self.k, self.conv = conv.kernel_size[0], copy.deepcopy(conv)
            self.conv.padding = (0, 0)

        def forward(self, x):
            return self.conv(thv.tf_same_pad(x, self.k, 1))

    route = copy.deepcopy(model)
    for owner in list(route.modules()):
        for name, child in list(owner.named_children()):
            if isinstance(child, torch.nn.Conv2d) and child.padding != (0, 0):
                setattr(owner, name, PadThenConv(child))
    return route


def bn_act_phase(torch, dev, card):
    """bn_act against its plain version at a chunk's four residual-block
    map sizes (bf16, the three forms: outputs and sums bit for bit), one
    timing line per size over the three forms (bytes: 2, 4 and 3 map
    passes); then HoVer-Net typing over one seeded chunk, ms a patch, in
    four variants: the port (bn_act, pads in the convolutions), the plain
    composition (bn_relu_reference), the pad copies (tf_same_pad before
    the symmetric convolutions), and both (the net before bn_act): the
    first two must agree bit for bit."""
    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.kernels import hovernet as kh
    from wsi_hgnn_tpu_torch.models.featurizers import hovernet as thv

    gen = torch.Generator(device=dev).manual_seed(21)
    per_shape, bounds = [], []
    total_ms = total_plain = total_issued = 0.0
    for h, c in BN_ACT_MAPS:
        shape = (CHUNK, c, h, h)
        bn = torch.nn.BatchNorm2d(c).to(dev).eval()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(c, generator=gen, device=dev) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=gen, device=dev))
            bn.running_mean.copy_(torch.randn(c, generator=gen, device=dev))
            bn.running_var.copy_(torch.rand(c, generator=gen, device=dev)
                                 + 0.1)
        bn = bn.to(torch.bfloat16)
        x, r = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
            for _ in range(2))
        calls, map_bytes = [], x.numel() * 2
        with torch.inference_mode():
            for form, res, keep in BN_ACT_FORMS:
                args = (x, bn, r if res else None, keep)
                got, want = kh.bn_act(*args), kh.bn_relu_reference(*args)
                torch.cuda.synchronize()
                same = (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]) if keep
                        else torch.equal(got, want))
                check(same, f"bn_act {form} at {list(shape)} differs from "
                      f"the plain ops")
                del got, want
                calls.append(args)
                passes = 2 + (2 if keep else 1 if res else 0)
                bounds.append(bound(passes * map_bytes, 0.0, "bfloat16"))

            def run(fn):
                return lambda: [fn(*a) for a in calls]
            ms = cuda_ms(run(kh.bn_act), reps=5,
                         what=f"bn_act bfloat16 {list(shape)}")
            issued = issued_ms(run(kh.bn_act), reps=5)
            plain = cuda_ms(run(kh.bn_relu_reference), reps=3,
                            what=f"bn_relu_reference bfloat16 {list(shape)}")
        forms = ", ".join(f for f, *_ in BN_ACT_FORMS)
        per_shape.append(shape_line(
            "bn_act", f"[{CHUNK},{h},{h},{c}] forms {forms}",
            len(BN_ACT_FORMS), ms, bounds[-len(BN_ACT_FORMS):], card,
            plain_ms=plain / len(BN_ACT_FORMS), issued=issued))
        total_ms += ms
        total_plain += plain
        total_issued += issued
        del x, r, calls, bn
    torch.cuda.empty_cache()
    n = len(BN_ACT_MAPS) * len(BN_ACT_FORMS)
    b_ms, b_by = mean_bound(bounds)
    result = dict(max_abs_err=0.0, ms=total_ms / n, plain_ms=total_plain / n,
                  bound_ms=b_ms, bound_by=b_by, issued_ms=total_issued / n,
                  per_shape=per_shape)

    # ---- HoVer-Net typing, ms a patch, the four variants ------------------
    model = convert.init_flax_like_(thv.HoVerNet.typing(N_TYPES, "fast"), 7)
    model = model.eval().to(dev, torch.bfloat16,
                            memory_format=torch.channels_last)
    route = _pad_copy_route(torch, thv, model)
    px = torch.rand(CHUNK, PATCH, PATCH, 3, generator=gen, device=dev)
    xt = thv._nchw(thv._constructor_orientation(px.to(torch.bfloat16)))
    variants = {}
    for name, net, plain in (("bn_act, pads in the convolutions", model, False),
                             ("plain composition", model, True),
                             ("bn_act, pad copies", route, False),
                             ("plain composition, pad copies (the net "
                              "before bn_act)", route, True)):
        def forward(net=net):
            return net.decode_branch("tp", net.encode(xt))
        thv.bn_act = kh.bn_relu_reference if plain else kh.bn_act
        try:
            with torch.inference_mode():
                before = kh.bn_act.launches
                tp = forward()
                torch.cuda.synchronize()
                launched = kh.bn_act.launches - before
                ms = cuda_ms(forward, reps=HOVER_REPS, warmup=1,
                             what=f"hovernet typing ({name})")
        finally:
            thv.bn_act = kh.bn_act
        check(launched == (0 if plain else TYPING_LAUNCHES),
              f"typing forward ({name}) launched bn_act {launched} times")
        variants[name] = (ms / CHUNK, tp)
    (fused_ms, tp_f), (plain_ms, tp_p), (copy_ms, tp_c), (parent_ms, tp_0) = \
        variants.values()
    check(torch.equal(tp_f, tp_p), "typing with bn_act differs from the "
          "plain composition")
    types = [thv.node_types_on_device(t.permute(0, 2, 3, 1), N_TYPES)
             for t in (tp_f, tp_c)]
    log(f"timing hovernet typing [{CHUNK},{PATCH},{PATCH},3] ms a patch: "
        + ", ".join(f"{k} {v[0]:.4g}" for k, v in variants.items())
        + f"; bn_act alone saves {parent_ms - copy_ms:.4g}, the pads alone "
        f"{parent_ms - plain_ms:.4g}, both {parent_ms - fused_ms:.4g}; "
        f"tp logits bn_act = plain bit for bit, pads in the convolutions "
        f"against pad copies max|diff| "
        f"{(tp_f.float() - tp_c.float()).abs().max().item():.3g}, node types "
        f"equal on {int((types[0] == types[1]).sum())}/{CHUNK} [{card}]")
    del model, route, px, xt, variants, tp_f, tp_p, tp_c, tp_0
    torch.cuda.empty_cache()
    return result


VIT_ROWS = 256 * 265    # a 256-patch chunk's token rows (UNI2-h, 265 tokens)
VIT_D, VIT_F = 1536, 4096     # UNI2-h's width; SwiGLU's half of fc1's 8192
VIT_FORMS = (("update and LayerNorm", True, True),
             ("LayerNorm alone", False, True),
             ("update alone", True, False))   # (form, branch, norm)
VIT_CHUNK_REPS = 3      # timed UNI2-h forwards of a chunk per variant
VIT_CHUNK = 256         # patches a chunk (the uni2h cell's)


def vit_phase(torch, dev, card):
    """UNI2-h's block kernels against their plain versions at a 256-patch
    chunk's rows: swiglu on fc1's [67840, 8192] output bit for bit;
    add_layer_norm at [67840, 1536] in its three forms, the stream and
    the LayerNorm bit for bit. One timing line each
    (bytes: swiglu reads 2F and writes F bf16 a row; add_layer_norm reads
    x f32 and writes its y bf16, plus the branch read and x written back
    with an update), beside the unfused ops; then UNI2-h (seeded, bf16)
    over one chunk, ms a patch, with the kernels and with the plain ops
    (the served path's launches are `uni2h_serving_phase`'s). Returns the
    results by kernel."""
    from wsi_hgnn_tpu_torch import kernels
    from wsi_hgnn_tpu_torch.kernels import vit as kv
    from wsi_hgnn_tpu_torch.models.featurizers import vit as tvit

    gen = torch.Generator(device=dev).manual_seed(23)
    results = {}
    with torch.inference_mode():
        h = (torch.randn(VIT_ROWS, 2 * VIT_F, generator=gen, device=dev)
             * 4).to(torch.bfloat16)
        check(torch.equal(kv.swiglu(h), kv.swiglu_reference(h)),
              f"swiglu at [{VIT_ROWS},{2 * VIT_F}] differs from "
              f"F.silu(a) * b")
        b = bound(VIT_ROWS * VIT_F * 2 * 3, 0.0, "bfloat16")
        ms = cuda_ms(lambda: kv.swiglu(h), reps=20, what="swiglu")
        issued = issued_ms(lambda: kv.swiglu(h), reps=20)
        plain = cuda_ms(lambda: kv.swiglu_reference(h), reps=10,
                        what="swiglu_reference")
        row = shape_line("swiglu", f"[{VIT_ROWS},{2 * VIT_F}]", 1, ms, [b],
                         card, plain_ms=plain, issued=issued)
        results["swiglu"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                 bound_ms=b[0], bound_by=b[1],
                                 issued_ms=issued, per_shape=[row])
        del h

        x = torch.randn(VIT_ROWS, VIT_D, generator=gen, device=dev) * 3
        gamma = (0.2 * torch.exp(0.1 * torch.randn(
            VIT_D, generator=gen, device=dev))).to(torch.bfloat16)
        branch = torch.randn(VIT_ROWS, VIT_D, generator=gen, device=dev
                             ).to(torch.bfloat16)
        norm = torch.nn.LayerNorm(VIT_D, eps=tvit.LN_EPS).to(dev)
        norm.weight.copy_(torch.rand(VIT_D, generator=gen, device=dev) + 0.5)
        norm.bias.copy_(torch.randn(VIT_D, generator=gen, device=dev) * 0.1)
        norm = norm.to(torch.bfloat16)
        per_shape, bounds = [], []
        total = total_plain = total_issued = 0.0
        for form, use_branch, use_norm in VIT_FORMS:
            args = (gamma if use_branch else None,
                    branch if use_branch else None,
                    norm if use_norm else None)
            s_k, s_p = x.clone(), x.clone()
            y_k = kv.add_layer_norm(s_k, *args)
            y_p = kv.add_layer_norm_reference(s_p, *args)
            torch.cuda.synchronize()
            check(torch.equal(s_k, s_p), f"add_layer_norm ({form}): the "
                  f"stream differs from torch.addcmul")
            check(not use_norm or torch.equal(y_k, y_p),
                  f"add_layer_norm ({form}): the LayerNorm differs from "
                  f"torch's")
            del y_k, y_p
            b = bound(VIT_ROWS * VIT_D * (4 + 6 * use_branch + 2 * use_norm),
                      0.0, "bfloat16")
            bounds.append(b)
            ms = cuda_ms(lambda: kv.add_layer_norm(s_k, *args), reps=20,
                         what=f"add_layer_norm {form}")
            issued = issued_ms(lambda: kv.add_layer_norm(s_k, *args),
                               reps=20)
            plain = cuda_ms(lambda: kv.add_layer_norm_reference(s_p, *args),
                            reps=10, what=f"add_layer_norm_reference {form}")
            per_shape.append(shape_line(
                "add_layer_norm", f"[{VIT_ROWS},{VIT_D}] {form}", 1, ms, [b],
                card, plain_ms=plain, issued=issued))
            total += ms
            total_plain += plain
            total_issued += issued
            del s_k, s_p
        n = len(VIT_FORMS)
        b_ms, b_by = mean_bound(bounds)
        results["add_layer_norm"] = dict(
            max_abs_err=0.0, ms=total / n, plain_ms=total_plain / n,
            bound_ms=b_ms, bound_by=b_by, issued_ms=total_issued / n,
            per_shape=per_shape)
        del x, branch
    torch.cuda.empty_cache()

    # ---- UNI2-h over one chunk, ms a patch: the kernels, the plain ops ---
    model = tvit.make_vit(dev, torch.bfloat16, seed=24)
    px = torch.randn(VIT_CHUNK, 3, model.img_size, model.img_size,
                     generator=gen, device=dev).to(torch.bfloat16)
    depth = len(model.blocks)
    variants = {}
    for name, plain in (("swiglu and add_layer_norm", False),
                        ("plain ops", True)):
        if plain:
            tvit.swiglu = kv.swiglu_reference
            tvit.add_layer_norm = kv.add_layer_norm_reference
        try:
            with torch.inference_mode():
                before = kernels.launch_counts()
                feats = model(px)
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                ms = cuda_ms(lambda: model(px), reps=VIT_CHUNK_REPS,
                             warmup=1, what=f"uni2-h chunk ({name})")
        finally:
            tvit.swiglu, tvit.add_layer_norm = kv.swiglu, kv.add_layer_norm
        delta = {k: after[k] - before[k] for k in after}
        got = {k: delta[k] for k in ("swiglu", "add_layer_norm")}
        want = ({"swiglu": 0, "add_layer_norm": 0} if plain else
                {"swiglu": depth, "add_layer_norm": 1 + 2 * depth})
        check(got == want, f"a UNI2-h chunk ({name}) launched {got}, "
              f"want {want}")
        variants[name] = (ms / VIT_CHUNK, feats)
    (fused_ms, f_k), (plain_ms, f_p) = variants.values()
    check(torch.equal(f_k, f_p), "a UNI2-h chunk's features with the "
          "kernels differ from the plain ops'")
    log(f"timing uni2-h chunk {list(px.shape)} bf16 ms a patch: kernels "
        f"{fused_ms:.4g}, plain ops {plain_ms:.4g} (saves "
        f"{plain_ms - fused_ms:.4g}); features equal bit for bit [{card}]")
    del model, px, variants, f_k, f_p, feats
    torch.cuda.empty_cache()
    return results


KERNELS = (
    ("knn_l2_fused", "wsi_hgnn_tpu_torch/csrc/knn.cu",
     "wsi_hgnn_tpu/ops/pallas_knn.py:101"),
    ("dense_layer_fused", "wsi_hgnn_tpu_torch/csrc/dense_layer.cu",
     "wsi_hgnn_tpu/ops/pallas_densenet.py:126"),
    ("transition_fused", "wsi_hgnn_tpu_torch/csrc/transition.cu",
     "wsi_hgnn_tpu/ops/pallas_densenet.py:183"),
    ("bn_act", "wsi_hgnn_tpu_torch/csrc/bn_act.cu",
     None),    # no TPU kernel: XLA fuses these passes on the TPU
    ("swiglu", "wsi_hgnn_tpu_torch/csrc/vit_block.cu",
     None),    # no TPU kernel: the JAX package has no ViT
    ("add_layer_norm", "wsi_hgnn_tpu_torch/csrc/vit_block.cu", None),
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
TYPING_LAUNCHES = 76      # bn_act a HoVer-Net typing forward: every BNRelu
DENSENET_PER_CHUNK = {"dense_layer_fused": 58, "transition_fused": 3}
# a chunk of KimiaNet features with HoVer-Net typing (none of UNI2-h's)
PER_CHUNK = {**DENSENET_PER_CHUNK, "bn_act": TYPING_LAUNCHES, "swiglu": 0,
             "add_layer_norm": 0}
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
    launch counts, and hold the card's answers against plain references
    on small inputs. Returns the launch counts of the served requests."""
    import numpy as np

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import parse_lattice_twin
    from wsi_hgnn_tpu_torch.models.featurizers import (
        HoVerNet, KimiaNet, fuse_kimianet, hovernet_typing_apply,
        kimianet_fused_apply)
    from wsi_hgnn_tpu_torch.models.featurizers import _norm_pixels
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
    pred.featurize = featurize

    log(f"bn_act: {per_request[0]['bn_act']} launches for the "
        f"{requests[0][0]}-patch request ({TYPING_LAUNCHES} a chunk of "
        f"{chunk})")
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

    return launches


# GNN section of configs/BRCA/GAT_kimia_classification.yml at UNI2-h's
# width (the uni2h-serve-pixels cell's configuration)
GAT_UNI2H = {"name": "GAT", "negative_slope": 0.2, "num_layers": 2,
             "in_dim": 1536, "hidden_dim": 512, "residual": True,
             "in_drop": 0.2, "attn_drop": 0.2, "out_dim": 2, "num_heads": 4,
             "num_out_heads": 1, "feat_drop": 0.2,
             "graph_pooling_type": "mean"}
UNI2H_N = 600     # patches of the UNI2-h request: 3 chunks, the last ragged


def uni2h_serving_phase(torch, dev, card, kernels, n=UNI2H_N,
                        chunk=VIT_CHUNK):
    """The path the uni2h-serve-pixels cell serves: `SlidePredictor` with
    the GAT (seeded) and `enable_pixels(encoder_name="uni2-h")` (seeded
    bf16 UNI2-h), so uint8 upload, resize and normalisation inside
    `encode/vit`, chunks launched ahead, the exact KNN at D = 1536 and
    the GAT. Counters zeroed just before one n-patch request through
    `featurize` and `predict_many` and read just after: 24 `swiglu` and
    1 + 24 x 2 `add_layer_norm` launches a chunk, one KNN, none of
    HoVer-Net's or KimiaNet's. The served features equal the same
    request's with the plain ops bit for bit, and the card's
    probabilities the CPU predictor's on those features. Returns the
    launch counts of the request."""
    import numpy as np

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import parse_gnn_model
    from wsi_hgnn_tpu_torch.kernels import vit as kv
    from wsi_hgnn_tpu_torch.models.featurizers import vit as tvit
    from wsi_hgnn_tpu_torch.serve import SlidePredictor

    t0 = time.perf_counter()
    cfg = {"GNN": dict(GAT_UNI2H)}
    typed, hetero = parse_gnn_model(cfg["GNN"])
    check(not hetero, "the GAT parsed as a heterogeneous model")
    gnn_vars = convert.to_flax_variables(convert.init_flax_like_(typed,
                                                                 seed=25))
    pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                          variables=gnn_vars, device=dev)
    pred.enable_pixels(chunk=chunk, encoder_name="uni2-h", seed=26)
    pred.warmup_pixels(n)
    px = patch_pool(n, seed=27)
    log(f"uni2-h serving set-up (seeded GAT and UNI2-h, warm-up) "
        f"{time.perf_counter() - t0:.1f} s; GAT in {GAT_UNI2H['in_dim']} "
        f"hidden {GAT_UNI2H['hidden_dim']}, radius {RADIUS}, chunk {chunk}")

    # ---- the main path: counters from 0, one request ---------------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    feats, types = pred.featurize(px)
    probs = pred.predict_many([(feats, types)])
    ms = (time.perf_counter() - t) * 1e3
    launches = kernels.launch_counts()
    depth, chunks = tvit.UNI2H["depth"], -(-n // chunk)
    want = {"knn_l2_fused": 1, "dense_layer_fused": 0, "transition_fused": 0,
            "bn_act": 0, "swiglu": depth * chunks,
            "add_layer_norm": (1 + 2 * depth) * chunks}
    log(f"uni2-h request {n} patches ({chunks} chunks of {chunk}): "
        f"{ms:.1f} ms, probs {probs[0].tolist()}, launches {launches}")
    check(launches == want, f"the {n}-patch UNI2-h request launched "
          f"{launches}, want {want}")
    check(feats.shape == (n, GAT_UNI2H["in_dim"]) and np.isfinite(feats).all()
          and not types.any(), f"UNI2-h features not finite [{n}, "
          f"{GAT_UNI2H['in_dim']}], or node types not all 0")
    check(probs.shape == (1, GAT_UNI2H["out_dim"])
          and np.isfinite(probs).all()
          and abs(float(probs.sum()) - 1.0) <= 1e-5,
          f"GAT probabilities {probs} not finite or not summing to 1")

    # ---- the same request with the plain ops; the GAT on the CPU ---------
    tvit.swiglu = kv.swiglu_reference
    tvit.add_layer_norm = kv.add_layer_norm_reference
    try:
        plain, _ = pred.featurize(px)
    finally:
        tvit.swiglu, tvit.add_layer_norm = kv.swiglu, kv.add_layer_norm
    check(np.array_equal(feats, plain), "the served UNI2-h features with "
          "swiglu and add_layer_norm differ from the plain ops'")
    cpu = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                         variables=gnn_vars, device="cpu")
    err = float(np.abs(probs - cpu.predict_many([(feats, types)])).max())
    log(f"uni2-h served features equal the plain ops' bit for bit; GAT "
        f"probabilities, card vs CPU plain path: max|err| {err:.3g} (atol "
        f"1e-4) [{card}]")
    check(err <= 1e-4, f"card GAT probabilities differ from the CPU path "
          f"by {err}")
    del pred
    torch.cuda.empty_cache()
    return launches



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
    results["bn_act"] = bn_act_phase(torch, dev, card)
    results.update(vit_phase(torch, dev, card))
    for name, r in results.items():
        log(f"timing {name}: {r['ms']:.4g} ms/launch (bound {r['bound_ms']:.4g}"
            f" ms by {r['bound_by']}; plain {r['plain_ms']:.4g} ms; "
            f"host-issued events {r['issued_ms']:.4g} ms) [{card}]")
    f32_kernel_timing(torch, dn, dev, gen_dev, card)
    log_hold(card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        counts = [slice_phase(torch, dev, card, kernels, Path(tmp)),
                  uni2h_serving_phase(torch, dev, card, kernels)]
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")

    # library_ms is null: no single PyTorch call computes any of the six
    # functions (a top-k KNN; a fused affine + GEMM + conv / pool chain;
    # an eval BatchNorm + ReLU after an add; a SwiGLU gate; an addcmul
    # followed by a LayerNorm of its bf16 cast)
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
