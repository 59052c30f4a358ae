"""Feature requests over HTTP under an open loop.

The program's `BatchingServer` (the settings in the workload: max_batch,
max_wait_ms, pad_batches) serves a `SlidePredictor` in this process; a
load generator in a process of its own (loadgen/open_loop.py) sends
`.npz` feature bodies from a seeded pool of log-spaced slide sizes at
Poisson arrivals of a fixed rate. Each request is timed from when it was
due. The window is the schedule: requests due in it are sent, and every
answer is awaited up to `tail_s` past its close.

Correct: every answer's probabilities against the reference's slide
graph and HEAT4 on the same body (made again from the seed). Compared:
  prob_gap   the largest absolute difference of an answered probability
A request that gets no answer, or an error, counts as failed.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from common import (HERE, Outcome, Trace, checks_from, free_device_memory,
                    now, percentile, sub_seed)
import models

sys.path.insert(0, str(HERE / "loadgen"))
from bodies import body_arrays, body_sizes  # noqa: E402


def run(ctx) -> Outcome:
    p, cfg = ctx.params, ctx.config
    dim = int(cfg["GNN"]["in_dim"])
    n_types = int(cfg["graph"]["n_node_types"])
    sizes = body_sizes(p["min_nodes"], p["max_nodes"], p["bodies"])
    body_seed = sub_seed(ctx.seed, "feature-bodies")
    gen_cfg = {"seed": body_seed, "sizes": sizes, "dim": dim,
               "n_types": n_types, "rate": float(p["rate_per_s"]),
               "seconds": ctx.seconds, "tail_s": float(p["tail_s"]),
               "concurrency": int(p["concurrency"])}
    client = subprocess.Popen(
        [sys.executable, str(HERE / "loadgen" / "open_loop.py"),
         json.dumps(gen_cfg)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        return _serve(ctx, client, sizes, body_seed, dim, n_types)
    finally:
        if client.poll() is None:
            client.kill()
        client.wait()


def _serve(ctx, client, sizes, body_seed, dim, n_types) -> Outcome:
    import torch

    from wsi_hgnn_tpu_torch.serve import BatchingServer

    p, cfg, dev = ctx.params, ctx.config, ctx.device
    gnn_w = models.gnn_weights(cfg, ctx.seed, dev)
    pred = models.predictor(cfg, gnn_w, dev)
    server = BatchingServer(pred, port=0, max_batch=int(p["max_batch"]),
                            max_wait_ms=float(p["max_wait_ms"]),
                            pad_batches=bool(p["pad_batches"]))
    try:
        for cap in p["warm_buckets"]:
            server.warmup(int(cap))
        server.start()
        ready = client.stdout.readline().strip()
        if ready != "ready":
            raise RuntimeError(f"load generator failed to start: {ready!r}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pred.reset_timing()
        with server._stats_lock:
            stats0 = dict(server.stats)
        trace = Trace(ctx.trace)
        t0 = now()
        setup_s = t0 - ctx.t_start
        trace.start()
        client.stdin.write(f"go {server.port}\n")
        client.stdin.flush()
        if trace.active:
            time.sleep(min(float(p["trace_s"]), ctx.seconds))
            trace.stop()
        out_line = client.stdout.readline()
        window_s = now() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        with server._stats_lock:
            stats1 = dict(server.stats)
        timing = dict(pred.timing)
    finally:
        server.stop()
    results = json.loads(out_line)
    if isinstance(results, dict):
        raise RuntimeError(results.get("error", "load generator failed"))

    deadline = ctx.seconds + float(p["tail_s"])
    lat_ms, lateness, failed, answers, dues = [], [], 0, [], []
    for r in results:
        if r is None:
            failed += 1
            lat_ms.append(deadline * 1e3)
            dues.append(None)
            continue
        dues.append(r[1])
        body, due, sent, done, status, answer = r
        lateness.append(sent - due)
        ok = status == 200 and isinstance(answer, list)
        if not ok:
            failed += 1
            lat_ms.append(max(done, deadline) * 1e3 - due * 1e3)
            continue
        lat_ms.append((done - due) * 1e3)
        answers.append((body, np.asarray(answer, np.float32)))
    ctx.log(f"load generator: {len(results)} requests due at "
            f"{p['rate_per_s']} req/s, sent late by p50 "
            f"{percentile(lateness, 0.5) * 1e3:.3f} ms, p99 "
            f"{percentile(lateness, 0.99) * 1e3:.3f} ms, max "
            f"{max(lateness) * 1e3:.3f} ms; {failed} failed")
    counters = {k: stats1[k] - stats0[k] for k in
                ("requests", "batches", "errors", "decode_ms_sum",
                 "latency_ms_sum")}
    real_sizes = [sizes[b] for b, _ in answers]
    record = {"window_s": window_s, "counters": counters, "timing": timing,
              "trace": trace.result, "served_sizes": real_sizes,
              "traced": {"requests_due": sum(1 for r in results if r and r[1] < float(p["trace_s"]))},
              "gnn": dict(cfg["GNN"]), "radius": int(cfg["graph"]["radius"]),
              "latency_by_due": list(zip(dues, lat_ms)),
              "lateness_s": lateness}
    if trace.result is not None:
        # the slides whose answers the traced sub-window served, by due time
        ts = trace.result["window_s"]
        record["traced"]["sizes"] = [sizes[r[0]] for r in results
                                     if r and r[3] <= ts]

    # ---- correct ----
    del pred, server
    free_device_memory()
    from reference import gnn as ref_gnn
    from reference.precision import Prec

    prec = Prec("f32")
    radius = int(cfg["graph"]["radius"])
    want, other = {}, {}
    with torch.no_grad():
        for b in sorted({b for b, _ in answers}):
            f, t = body_arrays(body_seed, b, sizes[b], dim, n_types)
            f = torch.from_numpy(f).to(dev)
            t = torch.from_numpy(t).to(dev).long()
            # every graph an exact f32 KNN may build (reference/gnn.py)
            want[b] = [torch.softmax(ref_gnn.heat4_logits(
                gnn_w, g, cfg["GNN"], prec), -1)[0].cpu().numpy()
                for g in ref_gnn.tie_variants(f, t, radius)]
            if ctx.control:
                tf = Prec("tf32")
                g2 = ref_gnn.slide_graph(f, t, radius, tf)
                other[b] = torch.softmax(
                    ref_gnn.heat4_logits(gnn_w, g2, cfg["GNN"], tf), -1)[0].cpu().numpy()

    def gap_to(a, b):
        return min(float(np.abs(a - w).max()) for w in want[b])

    gap = max((gap_to(a, b) for b, a in answers), default=float("inf"))
    control = {}
    if ctx.control:
        control["prob_gap"] = max(gap_to(other[b], b) for b in other)
    free_device_memory()
    return Outcome(
        attempted=len(results), failed=failed,
        end_to_end={"setup_s": setup_s,
                    "ft_latency_p95_ms": percentile(lat_ms, 0.95)},
        record=record,
        checks=checks_from({"prob_gap": gap}, ctx.workload["limits"]),
        memory_peak_bytes=peak, control_checks=control)
