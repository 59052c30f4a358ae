#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`wsi_hgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, one card, exit 0 when all holds

1. Prints the card (`nvidia-smi` name and power limit) and builds every
   CUDA kernel from `wsi_hgnn_tpu_torch/csrc` with nvcc for sm_90a, one
   nvcc per source, all at once.
2. Kernel phases: each kernel against its plain PyTorch version at the
   main path's shapes, with the tolerance printed beside the error.
3. The slice: `SlidePredictor` at the width of
   configs/BRCA/HEAT4_kimia_classification.yml, pixels in (KimiaNet
   features + HoVer-Net typing, bf16), exact KNN + Pearson lattice,
   HEAT4, softmax; requests of 2048, 1000 and 300 patches. The kernel
   launch counters are zeroed just before and read just after.
4. Timing lines (CUDA events per kernel launch, host clock per stage),
   and a torch.profiler pass over the last request: the device's busy
   share and the kernels that took the most device time.

The line before the last is the kernels JSON, the last line the device
JSON. Any failed check exits non-zero. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def knn_phase(torch, kn, dev, gen):
    """Exact-arithmetic inputs (small integers: every product and sum is
    exact in f32, so any summation order gives the same bits) with planted
    duplicate rows (exact ties) and a padding mask: indices and distances
    must be EXACTLY equal. Gaussian inputs: distances to 1e-5 relative,
    index mismatches only where two distances tie within that."""
    worst, rows = 0.0, []
    for n, n_real in ((2048, 2000), (384, 300)):
        f = torch.randint(-8, 9, (n, 1024), generator=gen,
                          dtype=torch.int32).float().to(dev)
        f[1::7] = f[0:n - 1:7][: f[1::7].shape[0]]  # planted exact ties
        mask = (torch.arange(n, device=dev) < n_real)
        i_k, d_k = kn.knn_l2_fused(f, 8, mask)
        i_p, d_p = kn.knn_l2_reference(f, 8, mask)
        torch.cuda.synchronize()
        check(torch.equal(i_k, i_p), f"knn idx differs (exact data, N={n})")
        check(torch.equal(d_k, d_p), f"knn d2 differs (exact data, N={n})")
        g = torch.randn(n, 1024, generator=gen).to(dev)
        i_k, d_k = kn.knn_l2_fused(g, 8, mask)
        i_p, d_p = kn.knn_l2_reference(g, 8, mask)
        err = (d_k - d_p).abs().max().item()
        rel = ((d_k - d_p).abs() / d_p.abs().clamp_min(1e-6)).max().item()
        mism = int((i_k != i_p).sum().item())
        check(rel <= 1e-5, f"knn d2 rel err {rel:.3g} > 1e-5 (N={n})")
        log(f"knn N={n} mask={n_real}: exact data idx+d2 equal; gaussian "
            f"max|d2 err| {err:.3g} (rel {rel:.3g} <= 1e-5), "
            f"{mism} index swaps at near-ties")
        worst = max(worst, err)
        rows.append((n, f))
    f = torch.randn(2048, 1024, generator=gen).to(dev)
    ms = cuda_ms(lambda: kn.knn_l2_fused(f, 8), reps=20)
    plain = cuda_ms(lambda: kn.knn_l2_reference(f, 8), reps=5)
    n, d = f.shape
    b_ms, b_by = bound(n * d * 4 + n * 4 + n * 8 * 8, 2.0 * n * n * d + 3 * n * d,
                       "float32")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by)


def layer_operands(torch, dev, gen, h, c_end, k_in, dtype):
    """Random operands of one dense layer at activation scale ~1."""
    x = torch.zeros(CHUNK, h, h, c_end)
    x[..., :k_in] = torch.randn(CHUNK, h, h, k_in, generator=gen)
    a1 = torch.zeros(1, c_end)
    b1 = torch.zeros(1, c_end)
    a1[0, :k_in] = torch.rand(k_in, generator=gen) + 0.5
    b1[0, :k_in] = torch.randn(k_in, generator=gen) * 0.1
    w1f = torch.zeros(c_end, 128)
    w1f[:k_in] = torch.randn(k_in, 128, generator=gen) * (2.0 / k_in) ** 0.5
    b2 = torch.randn(1, 128, generator=gen) * 0.1
    w2cat = torch.randn(128, 288, generator=gen) * (2.0 / 1152) ** 0.5
    return (x.to(dev, dtype), a1.to(dev), b1.to(dev), w1f.to(dev, dtype),
            b2.to(dev), w2cat.to(dev, dtype))


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


def dense_phase(torch, dn, dev, gen):
    worst = 0.0
    for h, ch, n_layers in BLOCKS:
        c_end = ch + 32 * n_layers
        for li in (0, n_layers - 1):
            k_in = ch + 32 * li
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                ops = layer_operands(torch, dev, gen, h, c_end, k_in, dtype)
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
                log(f"dense_layer H={h} k_in={k_in} C_end={c_end} {name}: "
                    f"max|err| {err:.3g} (rtol,atol {TOL[name]})")
                check(ok, f"dense layer mismatch H={h} k_in={k_in} {name}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    # time every layer of one 128-patch chunk in bf16 (58 launches)
    layers, bounds = [], []
    for h, ch, n_layers in BLOCKS:
        c_end = ch + 32 * n_layers
        x = None
        for li in range(n_layers):
            k_in = ch + 32 * li
            ops = layer_operands(torch, dev, gen, h, c_end, k_in,
                                 torch.bfloat16)
            x = ops[0] if x is None else x
            layers.append((x,) + ops[1:] + (k_in,))
            px = CHUNK * h * h
            bounds.append(bound(
                px * (k_in + 32) * 2 + (k_in * 128 + 128 * 288) * 2,
                2.0 * px * (k_in * 128 + 9 * 128 * 32), "bfloat16"))
    def run(fn):
        def go():
            for x, a1, b1, w1f, b2, w2cat, k_in in layers:
                fn(x, a1, b1, w1f, b2, w2cat,
                   n_active_groups=-(-k_in // 128), slot=k_in // 32)
        return go
    n_l = len(layers)
    ms = cuda_ms(run(dn.dense_layer_fused), reps=3, warmup=1) / n_l
    plain = cuda_ms(run(dn.dense_layer_reference), reps=1, warmup=1) / n_l
    b_ms, b_by = mean_bound(bounds)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by)


def transition_phase(torch, dn, dev, gen):
    worst, shapes = 0.0, []
    for h, c in ((64, 256), (32, 512), (16, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x = torch.randn(CHUNK, h, h, c, generator=gen).to(dev, dtype)
            a = (torch.rand(1, c, generator=gen) + 0.5).to(dev)
            b = (torch.randn(1, c, generator=gen) * 0.1).to(dev)
            w = (torch.randn(c, c // 2, generator=gen)
                 * (2.0 / c) ** 0.5).to(dev, dtype)
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
    ms = cuda_ms(lambda: [dn.transition_fused(*s) for s in shapes], reps=10)
    plain = cuda_ms(lambda: [dn.transition_reference(*s) for s in shapes],
                    reps=3)
    bounds = []
    for x, _, _, w in shapes:
        bsz, h, _, c = x.shape
        m = bsz * (h // 2) * (h // 2)
        bounds.append(bound(
            x.numel() * 2 + w.numel() * 2 + m * (c // 2) * 2 + 8 * c,
            2.0 * m * c * (c // 2) + 4.0 * m * 4 * c, "bfloat16"))
    b_ms, b_by = mean_bound(bounds)
    return dict(max_abs_err=worst, ms=ms / 3, plain_ms=plain / 3,
                bound_ms=b_ms, bound_by=b_by)


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


def slice_phase(torch, dev, card, kernels, gnn=GNN, requests=REQUESTS,
                chunk=CHUNK):
    """Serve one pixel request per entry of `requests` through
    SlidePredictor, check the answers and the kernel launch counts, hold
    the card's answers against plain references on small inputs, and time
    the first request stage by stage. Returns the launch counts of the
    served requests."""
    import numpy as np

    from wsi_hgnn_tpu_torch import convert
    from wsi_hgnn_tpu_torch.config import parse_lattice_twin
    from wsi_hgnn_tpu_torch.models.featurizers import (
        HoVerNet, KimiaNet, fuse_kimianet, hovernet_typing_apply,
        kimianet_fused_apply)
    from wsi_hgnn_tpu_torch.models.featurizers import _norm_pixels
    from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
    from wsi_hgnn_tpu_torch.serve import SlidePredictor
    from wsi_hgnn_tpu_torch.utils import to_torch

    t0 = time.perf_counter()
    cfg = {"GNN": gnn}
    gnn_vars = convert.to_flax_variables(
        convert.init_flax_like_(parse_lattice_twin(gnn), seed=0))
    kimia = convert.init_flax_like_(KimiaNet(), seed=1).eval()
    kimia_vars = convert.to_flax_variables(kimia)
    hover = convert.init_flax_like_(HoVerNet(N_TYPES, "fast"), seed=2).eval()
    hover_vars = convert.to_flax_variables(hover)
    pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=N_TYPES,
                          variables=gnn_vars, device=dev)
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
    profile_request(torch, pred, slides[-1], requests[-1][0], card)
    return launches


def profile_request(torch, pred, px, n: int, card: str, top: int = 12):
    """torch.profiler over one served request: the device's busy share (the
    union of its kernel and copy intervals over the request's host-clock
    span) and the kernels that took the most device time. A profiler that
    records no device activity leaves both unmeasured; it fails nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("served_request"):
            pred.predict_many_pixels([px])
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "served_request"
                and e.device_type == DeviceType.CPU)
    # the annotation also appears on the device's timeline: not a kernel
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and e.name != "served_request")
    if not dev:
        log(f"profile of the {n}-patch request: torch.profiler recorded no "
            f"device activity; busy share not measured [{card}]")
        return
    busy, reach, per_name = 0.0, span.start, {}
    for start, end, name in dev:
        lo, hi = max(start, reach), min(end, span.end)
        if hi > lo:
            busy += hi - lo
            reach = hi
        per_name[name] = per_name.get(name, 0.0) + (end - start)
    dev_total = sum(per_name.values())
    wall = span.end - span.start
    log(f"profile of the {n}-patch request (torch.profiler, CPU+CUDA): "
        f"span {wall / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall:.3f} of the span), device time summed over "
        f"{len(dev)} kernels and copies {dev_total / 1e3:.1f} ms [{card}]")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / 1e3:9.2f} ms {us / dev_total:6.3f}  {name[:100]}")


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
    set_cuda_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    results = {}
    results["knn_l2_fused"] = knn_phase(torch, kn, dev, gen)
    results["dense_layer_fused"] = dense_phase(torch, dn, dev, gen)
    results["transition_fused"] = transition_phase(torch, dn, dev, gen)
    for name, r in results.items():
        log(f"timing {name}: {r['ms']:.4g} ms/launch (bound {r['bound_ms']:.4g}"
            f" ms by {r['bound_by']}; plain {r['plain_ms']:.4g} ms) "
            f"[{card}]")

    launches = slice_phase(torch, dev, card, kernels)

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
