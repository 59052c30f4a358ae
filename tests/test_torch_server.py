"""Port parity of the micro-batching HTTP server (wsi_hgnn_tpu_torch/
serve.py::BatchingServer, tools/serve.py) against the JAX package
(tests/test_serve.py's contract): the port serves a checkpoint the JAX
trainer's CheckpointManager wrote, and every answer equals the JAX
`SlidePredictor.predict` on that checkpoint to 1e-4, whatever requests
share its batch. Every wait on a socket, thread or event has its own
timeout, so a hung batcher fails its test, not the suite."""
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax

from wsi_hgnn_tpu.config import loads_config as jax_loads_config
from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu.graph import to_homogeneous as jax_to_homogeneous
from wsi_hgnn_tpu.graph.build import build_batch_device as jax_build
from wsi_hgnn_tpu.serve import SlidePredictor as JaxPredictor
from wsi_hgnn_tpu.train.checkpoint import CheckpointManager
from wsi_hgnn_tpu_torch.config import loads_config
from wsi_hgnn_tpu_torch.serve import BatchingServer, SlidePredictor, _Request
import port_threads  # noqa: F401  (torch threads per test worker)

ROOT = Path(__file__).resolve().parent.parent
RADIUS, IN_DIM, WAIT = 4, 16, 60
CFG = """
name: ServeTest
GNN:
  name: "{gnn}"
  n_node_types: 6
  num_layers: 2
  in_dim: 16
  hidden_dim: 32
  out_dim: 2
  n_heads: 2
  num_heads: 2
  feat_drop: 0.0
  graph_pooling_type: mean
checkpoint:
  path: "{ckpt}"
"""


def write_jax_checkpoint(root: Path, gnn: str) -> str:
    """A version-1 checkpoint of the JAX model, written by the JAX
    package's CheckpointManager; returns the config file's path."""
    text = CFG.format(gnn=gnn, ckpt=str(root / "ckpt"))
    cfg = jax_loads_config(text)
    model, hetero = jax_parse_gnn_model(cfg["GNN"])
    rng = np.random.RandomState(0)
    g = jax_build(rng.randn(1, 64, IN_DIM).astype(np.float32),
                  rng.randint(0, 6, (1, 64)).astype(np.int32),
                  np.ones((1, 64), bool), RADIUS, 6)
    variables = model.init(jax.random.PRNGKey(0),
                           g if hetero else jax_to_homogeneous(g))
    CheckpointManager(str(root / "ckpt")).write_new_version(
        cfg, {"params": variables["params"],
              "batch_stats": variables.get("batch_stats", {})}, {"Epoch": 1})
    (root / "config.yml").write_text(text)
    return str(root / "config.yml")


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """{gnn: (JAX predictor, port predictor on the CPU)} over one JAX
    checkpoint each: GCN (TypedGraph path), HEAT2 (lattice path), HGT
    (hetero TypedGraph path)."""
    out = {}
    for gnn in ("GCN", "HEAT2", "HGT"):
        path = write_jax_checkpoint(tmp_path_factory.mktemp(gnn), gnn)
        text = Path(path).read_text()
        out[gnn] = (JaxPredictor(jax_loads_config(text), radius=RADIUS,
                                 n_node_types=6),
                    SlidePredictor(loads_config(text), radius=RADIUS,
                                   n_node_types=6, device="cpu"))
    return out


def _slide(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, IN_DIM).astype(np.float32),
            rng.randint(0, 6, n).astype(np.int32))


def _post(port, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as r:
        return json.loads(r.read())


def _concurrently(calls):
    """Run each zero-argument call in its own thread; their results, in
    order. Every thread must finish within the timeout."""
    results = [None] * len(calls)

    def run(i):
        results[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a request did not complete"
    return results


class _Served:
    """A started BatchingServer, stopped on exit."""

    def __init__(self, predictor, **kw):
        self.server = BatchingServer(predictor, **kw)

    def __enter__(self):
        self.server.start()
        return self.server

    def __exit__(self, *exc):
        self.server.stop()


def test_concurrent_requests_match_jax_predictor(predictors):
    """Six concurrent feature requests over the JAX checkpoint coalesce
    into fewer device calls; each answer equals the JAX predictor's
    answer for that slide alone to 1e-4. /healthz reports the checkpoint's
    version and /stats counts what was sent."""
    jax_pred, pred = predictors["GCN"]
    assert pred.version == jax_pred.version == 1
    slides = [_slide(48 + 7 * i, 10 + i) for i in range(6)]
    with _Served(pred, max_batch=6, max_wait_ms=2000.0) as server:
        assert _get(server.port, "/healthz") == {"status": "ok",
                                                 "model_version": 1}
        results = _concurrently([
            lambda s=s: _post(server.port, features=s[0], node_types=s[1])
            for s in slides])
        stats = _get(server.port, "/stats")
    for s, r in zip(slides, results):
        want = jax_pred.predict(*s)
        np.testing.assert_allclose(r["probs"], want, rtol=1e-4, atol=1e-4)
        assert r["pred"] == int(np.argmax(want))
    assert stats["requests"] == 6 and stats["errors"] == 0
    assert stats["batches"] < 6 and stats["batched_requests_max"] >= 2
    assert stats["decode_ms_sum"] > 0 and stats["latency_ms_sum"] > 0
    assert 0 < stats["queue_wait_ms_sum"] < stats["latency_ms_sum"]


def test_version_is_none_for_given_variables(predictors):
    _, pred = predictors["GCN"]
    from wsi_hgnn_tpu_torch import convert

    given = SlidePredictor(pred.config, radius=RADIUS, n_node_types=6,
                           device="cpu",
                           variables=convert.to_flax_variables(
                               pred.typed_model))
    assert given.version is None
    with _Served(given) as server:
        assert _get(server.port, "/healthz")["model_version"] is None


@pytest.mark.parametrize("gnn", ["HEAT2", "HGT"])
def test_hetero_answers_do_not_depend_on_batch_mates(predictors, gnn):
    """pad_batches repeats a group's first slide up to max_batch, and a
    hetero model's occupancy is per slide: slide A (node types {0, 1}
    only) answers the same alone (padded with copies of itself) as beside
    a full-type slide B, on the lattice (HEAT2) and TypedGraph (HGT)
    paths, and equals the JAX predictor's answer for A alone."""
    jax_pred, pred = predictors[gnn]
    assert (pred.model is not None) == (gnn == "HEAT2")
    rng = np.random.RandomState(7)
    fa = rng.randn(40, IN_DIM).astype(np.float32)
    ta = (rng.randint(0, 6, 40) % 2).astype(np.int32)
    fb, tb = _slide(40, 99)
    want = jax_pred.predict(fa, ta)
    with _Served(pred, max_batch=4, max_wait_ms=1000.0) as server:
        alone = _post(server.port, features=fa, node_types=ta)
        paired = _concurrently([
            lambda: _post(server.port, features=fa, node_types=ta),
            lambda: _post(server.port, features=fb, node_types=tb)])
        stats = _get(server.port, "/stats")
    assert stats["batched_requests_max"] == 2
    for r in (alone, paired[0]):
        np.testing.assert_allclose(r["probs"], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(paired[1]["probs"], jax_pred.predict(fb, tb),
                               rtol=1e-4, atol=1e-4)


def _fake_encoder(n_types=6):
    """Deterministic stand-in for the two-CNN encoder: mean RGB per patch
    through a fixed projection."""
    w = np.random.RandomState(123).randn(3, IN_DIM).astype(np.float32)

    def enc(patches):
        m = np.asarray(patches, np.float32).mean(axis=(1, 2))
        types = (np.abs(m.sum(1) * 1e3).astype(np.int64) % n_types)
        return (m @ w).astype(np.float32), types.astype(np.int32)

    return enc


def _pixels(n, seed, ps=8):
    return np.random.RandomState(seed).randint(
        0, 255, (n, ps, ps, 3)).astype(np.uint8)


def test_buckets_and_kinds_never_share_a_batch(predictors):
    """Concurrent requests group by (kind, size bucket): two small and two
    big feature slides (buckets 256 and 384) and two pixel slides of the
    small feature bucket run as at least three groups of at most 2, and
    each answer equals the JAX predictor's (pixels: on the same fake
    encoder's features)."""
    jax_pred, pred = predictors["GCN"]
    pred.enable_pixels(encoder=_fake_encoder(), patch_size=8, chunk=16)
    try:
        small = [_slide(40, 60 + i) for i in range(2)]
        big = [_slide(300, 70 + i) for i in range(2)]
        px = [_pixels(40, 80 + i) for i in range(2)]
        with _Served(pred, max_batch=6, max_wait_ms=1500.0) as server:
            calls = [lambda s=s: _post(server.port, features=s[0],
                                       node_types=s[1]) for s in small + big]
            calls += [lambda p=p: _post(server.port, pixels=p) for p in px]
            results = _concurrently(calls)
            stats = _get(server.port, "/stats")
        enc = _fake_encoder()
        wants = [jax_pred.predict(*s) for s in small + big]
        wants += [jax_pred.predict(*enc(p.astype(np.float32) / 255.0))
                  for p in px]
        for r, want in zip(results, wants):
            np.testing.assert_allclose(r["probs"], want, rtol=1e-4,
                                       atol=1e-4)
        assert stats["batches"] >= 3 and stats["batched_requests_max"] <= 2
        assert stats["requests"] == 6 and stats["errors"] == 0
    finally:
        pred._encoder = None


def test_error_replies(predictors):
    """400 for an undecodable body, a wrong feature width, out-of-range
    node types, pixels on a features-only server and wrong pixel shapes;
    413 for a body over max_body_mb before it is read; 404 elsewhere; a
    good request still answers."""
    jax_pred, pred = predictors["GCN"]
    feats, types = _slide(10, 31)

    def code_of(fn):
        with pytest.raises(urllib.error.HTTPError) as exc:
            fn()
        return exc.value.code, exc.value.read().decode()

    with _Served(pred) as server:
        port = server.port
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=b"not-an-npz")
        assert code_of(lambda: urllib.request.urlopen(bad, timeout=WAIT)
                       )[0] == 400
        assert code_of(lambda: _post(port, features=np.zeros((10, 99),
                                                             np.float32))
                       )[0] == 400
        for t in (np.full(10, 6, np.int32), np.full(10, -1, np.int32)):
            assert code_of(lambda t=t: _post(port, features=feats,
                                             node_types=t))[0] == 400
        code, body = code_of(lambda: _post(port, pixels=_pixels(4, 1)))
        assert code == 400 and "not configured" in body
        assert code_of(lambda: _get(port, "/nope"))[0] == 404
        out = _post(port, features=feats, node_types=types)
        np.testing.assert_allclose(out["probs"], jax_pred.predict(feats, types),
                                   rtol=1e-4, atol=1e-4)
        assert _get(port, "/stats")["requests"] == 1
    pred.enable_pixels(encoder=_fake_encoder(), patch_size=8, chunk=16)
    try:
        with _Served(pred) as server:
            for p in (_pixels(4, 6, ps=16), _pixels(4, 6).astype(np.float64)):
                assert code_of(lambda p=p: _post(server.port, pixels=p)
                               )[0] == 400
        with _Served(pred, max_body_mb=0.001) as server:
            assert code_of(lambda: _post(server.port,
                                         features=_slide(64, 1)[0]))[0] == 413
    finally:
        pred._encoder = None


def test_stop_fails_pending_requests(predictors):
    """stop() completes queued requests with an error instead of leaving
    their handler threads blocked."""
    server = BatchingServer(predictors["GCN"][1])  # batcher never started
    req = _Request(*_slide(12, 80))
    server.queue.put(req)
    server.stop()
    assert req.event.wait(timeout=WAIT)
    assert req.error == "server stopped"


def test_fatal_error_completes_the_whole_group(predictors):
    """Even a BaseException inside predict_many completes every request of
    the group, and a plain error is each request's 500 text."""
    server = BatchingServer(predictors["GCN"][1], max_wait_ms=50.0)
    try:
        def boom(slides):
            raise KeyboardInterrupt

        server.predictor = type("P", (), {
            "predict_many": staticmethod(boom)})()
        reqs = [_Request(*_slide(12, 90 + i)) for i in range(3)]
        for r in reqs:
            server.queue.put(r)
        with pytest.raises(KeyboardInterrupt):
            server._batch_once()
        assert all(r.event.is_set() and r.error == "server error"
                   for r in reqs)

        def fail(slides):
            raise ValueError("bad group")

        server.predictor.predict_many = staticmethod(fail)
        req = _Request(*_slide(12, 95))
        server.queue.put(req)
        server._batch_once()
        assert req.event.wait(timeout=WAIT)
        assert req.error == "ValueError: bad group"
    finally:
        server.stop()


def test_serve_tool_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch):
    """`python -m wsi_hgnn_tpu_torch.tools.serve` runs on the card by
    default and raises without one; with `--device cpu` it serves the
    JAX-written checkpoint (a subprocess on port 0, probed at /healthz
    and /predict, then terminated)."""
    import torch

    from wsi_hgnn_tpu_torch.tools import serve as tool

    config = write_jax_checkpoint(tmp_path, "GCN")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["-config", config, "--port", "0"])

    proc = subprocess.Popen(
        [sys.executable, "-m", "wsi_hgnn_tpu_torch.tools.serve", "-config",
         config, "--port", "0", "--device", "cpu", "--radius", str(RADIUS),
         "--warmup", "64"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        lines = []
        timer = threading.Timer(WAIT, proc.kill)
        timer.start()
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving model"):
                break
        timer.cancel()
        assert lines and lines[-1].startswith("serving model v1 on cpu"), lines
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        assert _get(port, "/healthz") == {"status": "ok", "model_version": 1}
        out = _post(port, features=_slide(50, 3)[0])
        assert len(out["probs"]) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT)
