"""Pixel slides, one at a time (a closed loop of one client).

Each request is a slide of uint8 256 x 256 patches: a seeded slice of one
pool made in set-up, its size from a fixed log-spaced set that every seed
serves in its own order. The window drives the served path itself:
`SlidePredictor.featurize` (KimiaNet features and HoVer-Net types, chunk
by chunk, the patches copied to the card every request) and then
`SlidePredictor.predict_many` (the slide graph and HEAT4), which is what
`predict_many_pixels` runs. Requests start while the window is open; it
closes when the last one started completes.

Correct: a sample of the served patches (drawn from the seed, the
largest slide's among them) is featurized again by the plain f32
reference, and every served slide's probabilities are computed again by
the reference graph and HEAT4 from the features the program served (the
reference follows the program here: PERF.md says so). Compared:
  feat_rel_l2     the largest relative L2 distance of a served feature row
  type_vote_gap   the mean over the sampled patches of the share of a
                  patch's pixels by which the reference's votes for the
                  served type fall short of its votes for its own type
  prob_gap        the largest absolute difference of a served probability
"""
from __future__ import annotations

import numpy as np

from common import (Outcome, Trace, checks_from, free_device_memory,
                    log_spaced_sizes, now, sub_seed)
import models


def plan(ctx, pool_n: int):
    """[(patches, offset)] of the requests, in serving order."""
    p = ctx.params
    sizes = log_spaced_sizes(p["min_patches"], p["max_patches"], p["sizes"])
    rng = np.random.default_rng(sub_seed(ctx.seed, "pixel-plan"))
    order = rng.permutation(len(sizes))
    return [(sizes[i], int(rng.integers(0, pool_n - sizes[i] + 1)))
            for i in order]


def run(ctx) -> Outcome:
    import torch

    from reference import cnn
    from reference.precision import Prec

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    pixels = cfg["pixels"]
    graph_cfg = cfg["graph"]
    pool = models.patch_pool(int(p["pool_patches"]), int(pixels["patch_size"]),
                             sub_seed(ctx.seed, "pixel-pool"), dev)
    ctx.log(f"set-up: pool made at {now() - ctx.t_start:.2f} s")
    gnn_w = models.gnn_weights(cfg, ctx.seed, dev)
    kimia_w, hover_w = models.cnn_weights(cfg, ctx.seed, dev,
                                          pool[:int(p["calib_patches"])])
    pred = models.predictor(cfg, gnn_w, dev)
    models.enable_pixels(pred, cfg, kimia_w, hover_w)
    ctx.log(f"set-up: weights and predictor at {now() - ctx.t_start:.2f} s")
    requests = plan(ctx, len(pool))
    # warm-up: one encoder chunk, the graph and HEAT4 at every bucket
    pred.featurize(pool[:int(pixels["chunk"])])
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
    while now() - t0 < ctx.seconds:
        n, off = requests[i % len(requests)]
        if i == 0:
            trace.start()
        with trace.span("featurize"):
            feats, types = pred.featurize(pool[off:off + n])
        with trace.span("predict_many"):
            probs = pred.predict_many([(feats, types)])[0]
        if i == 0:
            trace.stop()
        served.append((n, off, feats, types, probs))
        i += 1
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    timing = dict(pred.timing)
    patches = sum(s[0] for s in served)
    chunk = int(pixels["chunk"])
    traced = served[0]
    record = {
        "window_s": window_s,
        "patches": patches,
        "timing": timing,
        "trace": trace.result,
        "traced": {"patches": traced[0],
                   "chunks": -(-traced[0] // chunk), "chunk": chunk,
                   "knn_sizes": [traced[0]],
                   "gnn_sizes": [(traced[0], traced[0] * (int(graph_cfg["radius"]) - 1))],
                   "gnn": dict(cfg["GNN"])},
    }
    failed = sum(1 for s in served if not np.all(np.isfinite(s[4])))

    # ---- correct: the reference, once the program's state is freed ----
    del pred
    free_device_memory()
    prec = Prec("f32")
    rng = np.random.default_rng(sub_seed(ctx.seed, "pixel-sample"))
    n_sample = int(p["sample_patches"])
    biggest = int(np.argmax([s[0] for s in served]))
    rows = [(biggest, int(rng.integers(0, served[biggest][0])))]
    owners = rng.integers(0, len(served), n_sample - 1)
    rows += [(int(r), int(rng.integers(0, served[r][0]))) for r in owners]
    px = np.stack([pool[served[r][1] + j] for r, j in rows])
    px_dev = torch.from_numpy(px).to(dev)
    ref_f, ref_v = cnn.featurize(kimia_w, hover_w, px_dev, prec)
    got_f = torch.from_numpy(np.stack([served[r][2][j] for r, j in rows])).to(dev)
    got_t = torch.from_numpy(np.stack([served[r][3][j] for r, j in rows])
                             ).to(dev).long()
    values = {
        "feat_rel_l2": feat_rel_l2(got_f, ref_f),
        "type_vote_gap": float(vote_gaps(got_t, ref_v).mean()),
        "prob_gap": prob_gap(served, gnn_w, cfg, prec, dev),
    }
    record["diag"] = {"type_vote_gap_max": vote_gap(got_t, ref_v),
                      "type_disagree": float((got_t != cnn.node_types(ref_v)).float().mean())}
    control = {}
    if ctx.control:
        fp8 = Prec("fp8")
        c_f, c_v = cnn.featurize(kimia_w, hover_w, px_dev, fp8)
        c_t = cnn.node_types(c_v)
        record["diag"].update(
            control_type_vote_gap_max=vote_gap(c_t, ref_v),
            control_type_disagree=float((c_t != cnn.node_types(ref_v)).float().mean()))
        control = {"feat_rel_l2": feat_rel_l2(c_f, ref_f),
                   "type_vote_gap": float(vote_gaps(c_t, ref_v).mean()),
                   "prob_gap": prob_gap(served, gnn_w, cfg, prec, dev,
                                        other=Prec("tf32"))}
    free_device_memory()
    return Outcome(
        attempted=len(served), failed=failed,
        end_to_end={"setup_s": setup_s, "px_patches_per_s": patches / window_s},
        record=record, checks=checks_from(values, ctx.workload["limits"]),
        memory_peak_bytes=peak, control_checks=control)


def feat_rel_l2(got, want) -> float:
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def vote_gaps(types, votes):
    """Per patch: (votes for the reference's type - votes for `types`)
    over the patch's pixel count, the nonzero classes' majority rule."""
    from reference import cnn

    import torch

    want = cnn.node_types(votes)
    v = torch.cat([torch.zeros_like(votes[:, :1]), votes[:, 1:]], dim=1)
    gap = v.gather(1, want[:, None]) - v.gather(1, types.long()[:, None])
    return gap[:, 0].float() / votes.sum(1).float()


def vote_gap(types, votes) -> float:
    return float(vote_gaps(types, votes).max())


def prob_gap(served, gnn_w, cfg, prec, dev, other=None) -> float:
    """Largest |served probability - the reference's| over the served
    slides: the reference's HEAT4 on each slide's features and types, on
    whichever exact graph an f32 KNN may build agrees best
    (reference/gnn.py::tie_variants). With `other`, that precision's
    reference stands in for the program (the control)."""
    import torch

    from reference import gnn as ref_gnn

    worst = 0.0
    radius = int(cfg["graph"]["radius"])
    with torch.no_grad():
        for n, _, feats, types, probs in served:
            f = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)
            t = torch.from_numpy(np.asarray(types)).to(dev).long()
            if other is None:
                got = torch.from_numpy(np.asarray(probs, np.float32)).to(dev)
            else:
                g2 = ref_gnn.slide_graph(f, t, radius, other)
                got = torch.softmax(ref_gnn.heat4_logits(gnn_w, g2, cfg["GNN"], other), -1)[0]
            worst = max(worst, min(
                float((got - torch.softmax(ref_gnn.heat4_logits(
                    gnn_w, g, cfg["GNN"], prec), -1)[0]).abs().max())
                for g in ref_gnn.tie_variants(f, t, radius)))
    return worst
