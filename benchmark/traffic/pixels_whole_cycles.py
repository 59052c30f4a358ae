"""Pixel slides in whole cycles, one at a time (a closed loop of one
client), through a patch encoder with no HoVer-Net beside it.

Each request is a slide of uint8 256 x 256 patches: a seeded slice of one
pool made on the card in set-up and copied to the card with every
request. Its size is one of a fixed log-spaced set, which every seed
serves in an order of its own, the same order each cycle. The window
drives the served path itself: `SlidePredictor.featurize` (the
configuration's encoder, chunk by chunk; a homogeneous GNN reads no node
types, so no HoVer-Net runs) and then `SlidePredictor.predict_many` (the
slide graph with a self-loop a node, and the GNN). The window closes at
the end of the first whole cycle of the sizes that ends after --seconds,
so every run serves the same slides, cycle after cycle, and the patches
per second do not depend on where in a cycle a fixed time would fall.
With --trace 1 the profiler covers the first cycle's largest slide.

Correct: a sample of the served patches (drawn from the seed, the
largest slide's among them) is featurized again by the plain f32
reference (reference/vit.py), and every served slide's probabilities are
computed again by the reference graph and GNN (reference/gat.py) from
the features the program served. Compared:
  feat_rel_l2     the largest relative L2 distance of a served feature row
  prob_gap        the largest absolute difference of a served probability,
                  over every graph an exact f32 KNN may build
With --control (calibrate.py) the same numbers are read off the controls
in the program's place: the reference with fp8 products and its three
faults (reference/vit.py) for `feat_rel_l2`, the TF32 graph and GNN for
`prob_gap`.
"""
from __future__ import annotations

import numpy as np

from common import (Outcome, Trace, checks_from, free_device_memory, now,
                    sub_seed)
import models
# one cycle's [(patches, offset)] in serving order, as heat4-serve-pixels
# draws it from the seed; the worst relative L2 of a feature row
from traffic.pixels_closed import feat_rel_l2, plan


def run(ctx) -> Outcome:
    import torch

    from reference import gat
    from reference import vit as ref_vit
    from reference import weights as W
    from reference.precision import Prec

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    pixels, graph_cfg = cfg["pixels"], cfg["graph"]
    chunk = int(pixels["chunk"])
    arch = ref_vit.arch_of(cfg)
    gnn_w = W.make_weights(gat.spec(cfg["GNN"]), sub_seed(ctx.seed, "gnn"), dev)
    vit_w = ref_vit.make_weights(ref_vit.spec(arch),
                                 sub_seed(ctx.seed, "uni2-h"), dev)
    pred = models.predictor(cfg, gnn_w, dev)
    pred.enable_pixels(chunk=chunk, encoder_name=pixels["encoder"],
                       encoder_config={"vit": arch}, vit_state_dict=vit_w,
                       patch_size=int(pixels["patch_size"]))
    # the program holds its own bf16 copy; the reference's f32 weights wait
    # on the host until the check, so the window's memory is the program's
    vit_w = {k: v.cpu() for k, v in vit_w.items()}
    free_device_memory()
    ctx.log(f"set-up: weights and predictor at {now() - ctx.t_start:.2f} s")
    pool = models.patch_pool(int(p["pool_patches"]), int(pixels["patch_size"]),
                             sub_seed(ctx.seed, "pixel-pool"), dev)
    ctx.log(f"set-up: pool made at {now() - ctx.t_start:.2f} s")
    cycle = plan(ctx, len(pool))
    # the traced request: the cycle's largest slide, whole chunks only, so
    # every seed's per-layer readings cover the same work
    traced_i = max(range(len(cycle)), key=lambda j: cycle[j][0])
    # warm-up: one encoder chunk (every chunk is padded to its shape), the
    # graph and the GNN at every bucket
    pred.featurize(pool[:chunk])
    for cap in p["warm_buckets"]:
        pred.warmup(int(cap), batch_sizes=(1,))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pred.reset_timing()
    trace = Trace(ctx.trace)
    ctx.log(f"set-up: warmed up at {now() - ctx.t_start:.2f} s")

    served = []   # (patches, offset, features, types, probs)
    t0 = now()
    setup_s = t0 - ctx.t_start
    i = 0
    while True:
        n, off = cycle[i % len(cycle)]
        if i == traced_i:
            trace.start()
        with trace.span("featurize"):
            feats, types = pred.featurize(pool[off:off + n])
        with trace.span("predict_many"):
            probs = pred.predict_many([(feats, types)])[0]
        if i == traced_i:
            trace.stop()
        served.append((n, off, feats, types, probs))
        i += 1
        if i % len(cycle) == 0 and now() - t0 >= ctx.seconds:
            break
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    patches = sum(s[0] for s in served)
    traced = served[traced_i][0]
    k = int(graph_cfg["radius"]) - 1
    record = {
        "window_s": window_s,
        "patches": patches,
        "cycles": i // len(cycle),
        "timing": dict(pred.timing),
        "trace": trace.result,
        "traced": {"patches": traced, "chunks": -(-traced // chunk),
                   "chunk": chunk, "flops_per_patch": ref_vit.FLOPS_PER_PATCH,
                   # edges: k out-edges and a self-loop a node
                   "gnn_sizes": [(traced, traced * (k + 1))],
                   "gnn": dict(cfg["GNN"])},
    }
    failed = sum(1 for s in served if not np.all(np.isfinite(s[4])))

    # ---- correct: the reference, once the program's state is freed ----
    del pred
    free_device_memory()
    prec = Prec("f32")
    rng = np.random.default_rng(sub_seed(ctx.seed, "pixel-sample"))
    biggest = int(np.argmax([s[0] for s in served]))
    rows = [(biggest, int(rng.integers(0, served[biggest][0])))]
    owners = rng.integers(0, len(served), int(p["sample_patches"]) - 1)
    rows += [(int(r), int(rng.integers(0, served[r][0]))) for r in owners]
    px = torch.from_numpy(np.stack([pool[served[r][1] + j] for r, j in rows])
                          ).to(dev)
    vit_w = {k: v.to(dev) for k, v in vit_w.items()}
    ref_f = ref_vit.features(vit_w, px, arch)
    got_f = torch.from_numpy(np.stack([served[r][2][j] for r, j in rows])
                             ).to(dev)
    values = {"feat_rel_l2": feat_rel_l2(got_f, ref_f),
              "prob_gap": prob_gap(served, gnn_w, cfg, prec, dev)}
    control = {}
    if ctx.control:
        control["fp8.feat_rel_l2"] = feat_rel_l2(
            ref_vit.features(vit_w, px, arch, fp8=True), ref_f)
        for fault in ref_vit.FAULTS:
            control[f"{fault}.feat_rel_l2"] = feat_rel_l2(
                ref_vit.features(vit_w, px, arch, fault=fault), ref_f)
        control["tf32.prob_gap"] = prob_gap(served, gnn_w, cfg, prec, dev,
                                            other=Prec("tf32"))
    free_device_memory()
    return Outcome(
        attempted=len(served), failed=failed,
        end_to_end={"setup_s": setup_s, "px_patches_per_s": patches / window_s},
        record=record, checks=checks_from(values, ctx.workload["limits"]),
        memory_peak_bytes=peak, control_checks=control)


def prob_gap(served, gnn_w, cfg, prec, dev, other=None) -> float:
    """Largest |served probability - the reference's| over the served
    slides: the reference GAT on each slide's served features, on
    whichever exact graph an f32 KNN may build agrees best
    (reference/gnn.py::tie_variants). With `other`, that precision's
    reference graph and GAT stand in for the program (the control)."""
    import torch

    from reference import gat
    from reference import gnn as ref_gnn

    worst = 0.0
    radius = int(cfg["graph"]["radius"])
    gnn = cfg["GNN"]
    with torch.no_grad():
        for n, _, feats, _, probs in served:
            f = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)
            t = torch.zeros(n, dtype=torch.long, device=dev)
            if other is None:
                got = torch.from_numpy(np.asarray(probs, np.float32)).to(dev)
            else:
                g2 = ref_gnn.slide_graph(f, t, radius, other)
                got = torch.softmax(gat.logits(gnn_w, g2, gnn, other), -1)[0]
            worst = max(worst, min(
                float((got - torch.softmax(gat.logits(gnn_w, g, gnn, prec), -1)[0]
                       ).abs().max())
                for g in ref_gnn.tie_variants(f, t, radius)))
    return worst
