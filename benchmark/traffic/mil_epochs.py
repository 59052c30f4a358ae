"""Fine-tuning epochs of `train_mil`'s gigapath step on a seeded cohort.

Set-up makes the cohort from the seed: `slides` bags of log-spaced tile
counts from min_tiles to max_tiles (the same counts every seed), each of
seeded `feature_dim` tile embeddings with class structure (two balanced
labels) and the grid cells (col, row) of a seeded tissue-like blob in
the tiler's row-major order, the bags' `xy`, which train_mil's
`gigapath_coords` turns into the model's pixel coordinates. The bags stay
in host memory as `train_mil` holds them; each is uploaded inside its
step. It builds
train_mil's model and optimizer (`make_gigapath`, `gigapath_optimizer`)
with the seeded weights of reference/longnet.py and steps the first
epoch (a seeded shuffle, one slide a step) with train_mil's own
`gigapath_train_step`: the first `ref_steps` steps are kept for the
comparison, and the epoch runs every slide's shapes once. The window then
steps whole epochs, each in a seeded shuffle of its own, and closes at
the end of the first that ends after --seconds (a synchronise), so every
run steps the same slides. With --trace 1 the profiler covers the
window's first step of the largest slide.

Correct: the reference (reference/longnet.py) runs the same first steps
from the same weights on the same slides, in f32; compared as
train_epochs.py compares them, by its grad_gap and change_gap, over every
leaf but the key biases (`reference_leaves`). Its loss_gap is read too
and kept beside them (`diag`), with no limit: at
AdamW's 2e-3 the second and third losses follow the first step's update,
and the program's bf16 reads 0.007-0.034 there, against 0.006-0.121 for
the fp8 control (PERF.md, section 2). With --control (calibrate.py) the
three numbers are read off the reference with fp8 products and its three
planted faults in the program's place, and off the reading with the pad
rows masked.
"""
from __future__ import annotations

import numpy as np

from common import (Outcome, Trace, checks_from, free_device_memory,
                    log_spaced_sizes, now, sub_seed)
from traffic.train_epochs import BETA1, compare, compare_ref

# A key bias shifts the scores of a segment's real keys alike, which the
# softmax cancels: its gradient is the residue of the unmasked pad rows
# alone, which the program's bf16 round-off swamps, and AdamW's first
# steps move a leaf by the sign of its gradient, whatever its size.
KEY_BIAS = ".self_attn.k_proj.bias"

CONTROLS = (("fp8", {"fp8": True}),
            ("heads_offset0", {"fault": "heads_offset0"}),
            ("mean_merge", {"fault": "mean_merge"}),
            ("skip_last_layer", {"fault": "skip_last_layer"}),
            ("pads_masked", {"mask_pads": True}))


def reference_leaves(want):
    """The reference's steps with its key biases out of the compared
    leaves (train_epochs compares the leaves of its first gradient)."""
    return dict(want, grad1={k: v for k, v in want["grad1"].items()
                             if not k.endswith(KEY_BIAS)})


def tissue_blob(n: int, rng: np.random.Generator, ngrids: int) -> np.ndarray:
    """[n, 2] int64 grid cells (col, row) of n tiles of a seeded blob with
    a wobbling rim and a ragged edge, row-major (row, then col)."""
    side = int(np.ceil(np.sqrt(n / 0.45))) + 8
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    c = (side - 1) / 2.0
    ang = np.arctan2(yy - c, xx - c)
    k = np.arange(1, 6)
    amp, phase = rng.normal(0, 0.12, 5) / k, rng.uniform(0, 2 * np.pi, 5)
    rim = 1.0 + (amp[:, None, None] * np.cos(k[:, None, None] * ang
                                             + phase[:, None, None])).sum(0)
    aspect = rng.uniform(0.7, 1.0)
    dist = (np.hypot(xx - c, (yy - c) / aspect) / rim
            + rng.uniform(0, 1.5, (side, side)))
    cells = np.sort(np.argsort(dist.ravel(), kind="stable")[:n])
    y, x = np.divmod(cells, side)
    origin = rng.integers(0, ngrids - side, 2)
    return (np.stack([x, y], 1) + origin).astype(np.int64)


def make_cohort(ctx, arch):
    """(features [N, D] f32 host arrays, grid cells, labels, tile counts)."""
    import torch

    p, dev = ctx.params, ctx.device
    sizes = log_spaced_sizes(p["min_tiles"], p["max_tiles"], p["slides"])
    dim = int(p["feature_dim"])
    rng = np.random.default_rng(sub_seed(ctx.seed, "cohort"))
    labels = np.zeros(len(sizes), np.int64)
    labels[rng.permutation(len(sizes))[:len(sizes) // 2]] = 1
    gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, "cohort-feat"))
    protos = torch.randn((16, dim), generator=gen, device=dev)
    shift = 0.5 * torch.randn((2, dim), generator=gen, device=dev)
    feats, coords = [], []
    for n, y in zip(sizes, labels):
        which = torch.randint(0, 16, (n,), generator=gen, device=dev)
        x = protos[which] + shift[y] + 0.5 * torch.randn((n, dim), generator=gen,
                                                         device=dev)
        feats.append(x.cpu().numpy())
        coords.append(tissue_blob(n, rng, arch["ngrids"]))
    return feats, coords, labels, sizes


def model_sizes(arch, cfg):
    m = cfg["model"]
    return dict(dim=arch["dim"], depth=arch["depth"], heads=arch["heads"],
                mlp_ratio=arch["mlp_hidden"] / arch["dim"],
                segment_lengths=arch["segment_lengths"],
                dilated_ratios=arch["dilated_ratios"], ngrids=arch["ngrids"],
                tile_size=arch["tile_size"], dropout=float(m["dropout"]),
                drop_path_rate=float(m["drop_path_rate"]))


def run(ctx) -> Outcome:
    import torch

    from wsi_hgnn_tpu_torch import train_mil

    if not hasattr(train_mil, "gigapath_train_step"):
        raise RuntimeError("train_mil has no 'gigapath' model: this program "
                           "cannot run the cell")
    from reference import longnet as ref

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    arch = ref.arch_of(cfg)
    opt_cfg = {k: float(cfg["optimizer"][k])
               for k in ("lr", "weight_decay", "layer_decay")}
    n_ref = int(p["ref_steps"])
    feats, cells, labels, sizes = make_cohort(ctx, arch)
    coords = train_mil.gigapath_coords(cells, arch["ngrids"], arch["tile_size"])
    ctx.log(f"set-up: cohort of {sum(sizes)} tiles at {now() - ctx.t_start:.2f} s")
    w = ref.make_weights(ref.spec(arch), sub_seed(ctx.seed, "weights"), dev)
    model = train_mil.make_gigapath(arch["in_dim"], arch["n_classes"], dev,
                                    **model_sizes(arch, cfg))
    model.load_state_dict(w)
    opt = train_mil.gigapath_optimizer(model, dev, **opt_cfg)
    # the reference's weights wait on the host: the window's memory is the
    # program's
    w = {k: v.cpu() for k, v in w.items()}
    named = dict(model.named_parameters())
    order_rng = np.random.RandomState(sub_seed(ctx.seed, "order"))

    def step(i):
        return train_mil.gigapath_train_step(model, opt, feats[i], coords[i],
                                             int(labels[i]), dev)

    # the first epoch: the compared steps, and every slide's shapes once
    first = order_rng.permutation(len(feats))
    losses, adam1, after = [], None, None
    for s, i in enumerate(first):
        loss = step(i)
        if s < n_ref:
            losses.append(float(loss))
        if s == 0:
            # a step that left the optimizer untouched has no moment: it
            # reads as a zero gradient
            adam1 = {f"params/{k}": opt.state[v].get(
                "exp_avg", torch.zeros_like(v)).detach().cpu() / (1 - BETA1)
                for k, v in named.items()}
        if s == n_ref - 1:
            after = {f"params/{k}": v.detach().to("cpu", copy=True)
                     for k, v in named.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ctx.log(f"set-up: first epoch done at {now() - ctx.t_start:.2f} s")

    trace = Trace(ctx.trace)
    largest = int(np.argmax(sizes))
    traced, window_losses = [], []
    epochs = slides = 0
    t0 = now()
    setup_s = t0 - ctx.t_start
    while True:
        for i in order_rng.permutation(len(feats)):
            tracing = ctx.trace and not traced and i == largest
            if tracing:
                trace.start()
            with trace.span("train_step"):
                window_losses.append(step(i))
            if tracing:
                trace.stop()
                traced.append(sizes[i] + 1)
            slides += 1
        epochs += 1
        if now() - t0 >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    ctx.log(f"window: {epochs} epochs, {slides} slides in {window_s:.3f} s")
    record = {"window_s": window_s, "steps": slides, "trace": trace.result,
              "traced": {"tokens": traced}, "arch": arch}
    del model, opt, named
    free_device_memory()

    # ---- correct ----
    w0 = {"params": w}
    slides_ref = [(feats[i], coords[i], labels[i]) for i in first[:n_ref]]
    want = reference_leaves(ref.reference_steps(w, slides_ref, arch, opt_cfg,
                                                dev))
    values = compare(losses, adam1, after, w0, want)
    record["diag"] = {"loss_gap": values.pop("loss_gap")}
    control = {}
    if ctx.control:
        for name, kw in CONTROLS:
            other = ref.reference_steps(w, slides_ref, arch, opt_cfg, dev, **kw)
            control.update({f"{name}.{k}": v for k, v in
                            compare_ref(other, w0, want).items()})
    free_device_memory()
    return Outcome(
        attempted=slides, failed=failed,
        end_to_end={"setup_s": setup_s, "train_slides_per_s": slides / window_s},
        record=record, checks=checks_from(values, ctx.workload["limits"]),
        memory_peak_bytes=peak, control_checks=control)
