"""Slide-to-prediction serving (counterpart of wsi_hgnn_tpu/serve.py):
`SlidePredictor` and the micro-batching HTTP server `BatchingServer`.

A request carries patch features [N, D] (+ node types), or raw patch
pixels once `enable_pixels` attached a patch encoder (KimiaNet,
EfficientNet-B4 or UNI2-h features, with HoVer-Net typing over the same
patch stream for a heterogeneous model). Slides of a group are
padded to one size bucket and their graphs built on the device (KNN +
Pearson, one KNN launch per slide). Two paths answer, chosen as the JAX
predictor chooses:

  * the lattice path: a model with a lattice twin (HEAT2/HEAT4) on the
    [B, N, k] lattice with per-slide occupancy (presence='graph'), when
    the group fits the JAX package's one-hot memory budget;
  * the TypedGraph path: every other model (and oversized groups), one
    forward per slide of the group on its own TypedGraph, with explicit
    self-loops and the untyped view for homogeneous models (what they
    were trained on).

Either way a response never depends on which other requests share its
group. The weights (and GIN's running statistics) come from a checkpoint
directory written by either package's trainer (its latest version, which
`version` reports), or as a flax-layout tree (`variables=`, no version).

`BatchingServer` is a stdlib ThreadingHTTPServer: handler threads decode
and validate requests and queue them; one batcher thread groups up to
`max_batch` requests of one bucket (kind 'px' or 'ft', size bucket) that
arrive within `max_wait_ms` into one `predict_many` call. Wire format:
POST /predict with an .npz body holding `features` [N, D] f32 (+
`node_types` [N] int) or `pixels` [N, P, P, 3] uint8 / f32 in [0, 1],
answered with JSON {"probs": [...], "pred": k, "latency_ms": t}; GET
/healthz and GET /stats.
"""
from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import convert, profiling
from .config import parse_gnn_model, parse_lattice_twin
from .data.lattice_loader import lattice_batch_for_budget
from .graph.build import build_batch_device
from .graph.typed_graph import bucket_size, to_homogeneous
from .models.lattice import build_lattice_device
from .train.checkpoint import CheckpointManager
from .utils import resolve_device, set_cuda_numerics, to_numpy, to_torch


class SlidePredictor:
    """Serves per-slide predictions of a trained GNN.

    `config` is the training config dict (its GNN section picks the
    model). The weights are the latest version under `checkpoint_path`,
    or the model's flax-layout variable tree `variables` (numpy), or, when
    neither is given, the latest version under config['checkpoint']
    ['path']; `version` is the checkpoint version served (None for
    `variables`). `use_lattice=False` keeps a lattice-twin model on the
    TypedGraph path. The predictor runs on `device` ('cuda' unless the
    caller asks for 'cpu')."""

    def __init__(self, config: Dict, radius: int = 9, n_node_types: int = 6,
                 checkpoint_path: Optional[str] = None,
                 knn_impl: str = "exact", variables: Optional[Dict] = None,
                 device=None, use_lattice: bool = True,
                 lattice_mem_budget: int = 2 << 30):
        if variables is not None and checkpoint_path is not None:
            raise ValueError("pass checkpoint_path or variables, not both")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        typed, self.is_hetero = parse_gnn_model(config["GNN"])
        twin = parse_lattice_twin(config["GNN"]) if use_lattice else None
        self.version = None
        if variables is None:
            manager = CheckpointManager(
                checkpoint_path or config["checkpoint"]["path"])
            variables = manager.restore_variables()
            self.version = manager.version
        convert.load_flax_variables(typed, variables)
        self.typed_model = typed.to(self.device).eval()
        self.model = None
        if twin is not None:
            twin.presence = "graph"  # per-slide occupancy
            convert.load_flax_variables(twin, variables)
            self.model = twin.to(self.device).eval()
        self.lattice_mem_budget = int(lattice_mem_budget)
        self.config = config
        self.in_dim = int(config["GNN"]["in_dim"])
        self.radius = int(radius)
        self.n_node_types = int(n_node_types)
        self.knn_impl = knn_impl
        self._encoder = None
        self._lock = threading.Lock()  # device calls serialized per predictor
        self._warm_keys: set = set()
        self.reset_timing()

    def reset_timing(self) -> None:
        """Zero the overhead-split counters. A first call at a group shape
        (first kernel build, allocator growth) is booked to compile_ms.
        The pack and the wait for the device lock are spans
        (`predict/pack`, `predict/lock_wait`), recorded while a profiler
        runs."""
        self.timing = {
            "device_ms": 0.0, "compile_ms": 0.0, "calls": 0, "cold_calls": 0,
            "featurize_ms": 0.0, "featurize_chunks": 0,
        }

    # ------------------------------------------------------------------ #
    # pixels in
    # ------------------------------------------------------------------ #
    def enable_pixels(self, hovernet_config: Optional[Dict] = None,
                      kimianet_config: Optional[Dict] = None, encoder=None,
                      patch_size: int = 256, chunk: Optional[int] = None,
                      encoder_name: str = "kimia",
                      kimia_variables: Optional[Dict] = None,
                      hover_variables: Optional[Dict] = None,
                      seed: int = 0, encoder_config: Optional[Dict] = None,
                      vit_state_dict: Optional[Dict] = None) -> None:
        """Attach a patch-pixel featurizer: by default the caller's
        `encoder_name` (models.featurizers.make_cnn_encoder: 'kimia',
        'efficientnet-b4', 'uni2-h' or 'hover'; `encoder_config` adds to
        its config, e.g. `uni2h_model_path`) at the constructor's chunk
        size (hovernet_config batch_size, default 128), with HoVer-Net
        typing inline for a heterogeneous model only: a homogeneous one
        reads no types, and `featurize` gives it zeros. `encoder` injects
        a custom `(patches) -> (features, node_types)` callable."""
        hovernet_config = dict(hovernet_config or {})
        if chunk is None:
            chunk = int(hovernet_config.get("batch_size", 128) or 128)
        if encoder is None:
            from .models.featurizers import make_cnn_encoder

            encoder = make_cnn_encoder(
                encoder_name,
                {"feature_dim": self.in_dim, "n_node_type": self.n_node_types,
                 **(encoder_config or {})},
                hovernet_config, dict(kimianet_config or {}),
                with_typing=self.is_hetero, pad_batch_to=chunk,
                device=self.device, kimia_variables=kimia_variables,
                hover_variables=hover_variables, seed=seed,
                vit_state_dict=vit_state_dict)
        self._encoder = encoder
        self._patch_size = int(patch_size)
        self._chunk = int(chunk)

    @property
    def pixels_enabled(self) -> bool:
        return self._encoder is not None

    def featurize(self, pixels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Patch pixels [N, P, P, 3] (uint8, or f32 in [0, 1]) -> (features
        [N, D] f32, node_types [N] int32), chunk by chunk. Where the
        encoder has `launch` / `finish`, each chunk is launched before the
        one before it is finished, so the host pins and uploads a chunk
        while the card runs the last. While a profiler runs each chunk's
        launch is a `featurize/chunk` span, and the card's time from the
        end of a chunk's last device span (the encoder's stages) to the
        start of the next chunk's first is added to the counter
        `featurize/chunk_gap_ns`."""
        if not self.pixels_enabled:
            raise RuntimeError("pixels not enabled: call enable_pixels()")
        px = np.asarray(pixels)
        if px.dtype == np.uint8:
            if not getattr(self._encoder, "accepts_uint8", False):
                px = px.astype(np.float32) / 255.0
        else:
            px = px.astype(np.float32)
        launch = getattr(self._encoder, "launch", None)
        finish = getattr(self._encoder, "finish", None)
        if launch is None:
            launch, finish = self._encoder, (lambda out: out)
        feats, types = [], []

        def take(out):
            f, t = out
            feats.append(np.asarray(f, np.float32))
            types.append(np.zeros(len(f), np.int32) if t is None
                         else np.asarray(t, np.int32))

        with self._lock:
            t0 = time.perf_counter()
            last = pending = None
            for i in range(0, len(px), self._chunk):
                with profiling.span("featurize/chunk",
                                    step=i // self._chunk) as chunk:
                    launched = launch(px[i:i + self._chunk])
                if pending is not None:
                    take(finish(pending))
                pending = launched
                if last is not None:
                    profiling.count_elapsed("featurize/chunk_gap_ns",
                                            last.dev_last, chunk.dev_first)
                last = chunk
                self.timing["featurize_chunks"] += 1
            if pending is not None:
                take(finish(pending))
            self.timing["featurize_ms"] += (time.perf_counter() - t0) * 1e3
        return np.concatenate(feats), np.concatenate(types)

    def predict_many_pixels(self, slides: Sequence[np.ndarray]) -> np.ndarray:
        """[pixels [N_i, P, P, 3]] -> probs [B, C]."""
        return self.predict_many([self.featurize(px) for px in slides])

    def warmup_pixels(self, n_patches: int = 2048,
                      batch_sizes: Sequence[int] = (1,)) -> None:
        """Run one encoder chunk and the feature path once, so the first
        request pays neither the kernel build nor the allocator's growth."""
        px = np.zeros((min(n_patches, self._chunk), self._patch_size,
                       self._patch_size, 3), np.uint8)
        self.featurize(px)
        self.warmup(n_patches, batch_sizes=batch_sizes)

    # ------------------------------------------------------------------ #
    # features in
    # ------------------------------------------------------------------ #
    def pack(self, slides: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stack a group's slides into [B, N_cap, ...] padded buffers."""
        cap = max(bucket_size(len(f), base=256) for f, _ in slides)
        b = len(slides)
        d = slides[0][0].shape[1]
        feats = np.zeros((b, cap, d), np.float32)
        ntypes = np.zeros((b, cap), np.int64)
        mask = np.zeros((b, cap), bool)
        for i, (f, t) in enumerate(slides):
            n = len(f)
            feats[i, :n] = f
            if t is not None:
                ntypes[i, :n] = t
            mask[i, :n] = True
        return feats, ntypes, mask

    def uses_lattice(self, batch: int, cap: int) -> bool:
        """Whether a group of `batch` slides at node capacity `cap` takes
        the lattice path (the JAX predictor's budget rule)."""
        return self.model is not None and lattice_batch_for_budget(
            self.radius - 1, cap, self.lattice_mem_budget,
            max_batch=batch) == batch

    def _predict_lattice(self, feats, ntypes, mask) -> torch.Tensor:
        with profiling.span("predict/graph", device=self.device):
            g = build_lattice_device(feats, ntypes, mask, self.radius,
                                     self.n_node_types, knn_impl=self.knn_impl)
        with profiling.span("predict/model", device=self.device):
            return torch.softmax(self.model(g), dim=-1)

    def _predict_typed(self, feats, ntypes, mask) -> torch.Tensor:
        """One forward per slide, each on its own graph."""
        out = []
        for i in range(feats.shape[0]):
            with profiling.span("predict/graph", device=self.device, step=i):
                g = build_batch_device(
                    feats[i:i + 1], ntypes[i:i + 1], mask[i:i + 1],
                    self.radius, self.n_node_types, knn_impl=self.knn_impl,
                    add_self_loops=not self.is_hetero)
                if not self.is_hetero:
                    g = to_homogeneous(g)
            with profiling.span("predict/model", device=self.device, step=i):
                out.append(torch.softmax(self.typed_model(g), dim=-1))
        return torch.cat(out)

    def predict_many(self, slides: Sequence[Tuple[np.ndarray,
                                                  Optional[np.ndarray]]]
                     ) -> np.ndarray:
        """[(features [N_i, D], node_types [N_i] | None)] -> probs [B, C]
        for a group padded to one bucket."""
        with profiling.span("predict/pack"):
            feats, ntypes, mask = self.pack(slides)
            lattice = self.uses_lattice(*feats.shape[:2])
        fn = self._predict_lattice if lattice else self._predict_typed
        with profiling.span("predict/lock_wait"):
            self._lock.acquire()
        try:
            t0 = time.perf_counter()
            key = (lattice,) + feats.shape[:2]
            cold = key not in self._warm_keys
            with torch.inference_mode():
                out = fn(to_torch(feats, self.device),
                         to_torch(ntypes, self.device),
                         to_torch(mask, self.device))
                with profiling.span("predict/download"):
                    probs = to_numpy(out)
            t1 = time.perf_counter()
            self._warm_keys.add(key)
            self.timing["compile_ms" if cold else "device_ms"] += (t1 - t0) * 1e3
            self.timing["calls"] += 1
            self.timing["cold_calls"] += int(cold)
        finally:
            self._lock.release()
        return probs

    def predict(self, features: np.ndarray,
                node_types: Optional[np.ndarray] = None) -> np.ndarray:
        """Single slide: features [N, D] (+ node types [N]) -> probs [C]."""
        return self.predict_many([(np.asarray(features), node_types)])[0]

    def warmup(self, n_patches: int = 2048, feat_dim: Optional[int] = None,
               batch_sizes: Sequence[int] = (1,)) -> None:
        """Run the feature path once per group shape before real requests."""
        d = feat_dim or self.in_dim
        rng = np.random.RandomState(0)
        f = rng.randn(n_patches, d).astype(np.float32)
        t = rng.randint(0, self.n_node_types, n_patches).astype(np.int32)
        for b in batch_sizes:
            self.predict_many([(f, t)] * b)


# --------------------------------------------------------------------- #
# micro-batching HTTP server
# --------------------------------------------------------------------- #
class _Request:
    __slots__ = ("features", "node_types", "pixels", "bucket", "event",
                 "probs", "error", "enqueued")

    def __init__(self, features, node_types, pixels=None):
        self.features = features
        self.node_types = node_types
        self.pixels = pixels
        # only same-bucket requests share a group (a small slide never pays
        # a big one's padding); pixel requests run the encoder first, so
        # they never group with feature requests
        n = len(features) if pixels is None else len(pixels)
        self.bucket = ("px" if pixels is not None else "ft",
                       bucket_size(n, base=256))
        self.event = threading.Event()
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.enqueued = 0.0   # perf_counter at submit()


class BatchingServer:
    """HTTP front end with a micro-batching device loop.

    Handler threads enqueue requests; one batcher thread drains the queue,
    groups up to `max_batch` same-bucket requests that arrive within
    `max_wait_ms` of the first, and issues one `predict_many` per group.
    `pad_batches` pads every group to `max_batch` with repeats of its
    first slide (extra outputs dropped), so each bucket runs at one batch
    size; a response never depends on its batch-mates. Bodies over
    `max_body_mb` are refused before they are read."""

    def __init__(self, predictor: SlidePredictor, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 8,
                 max_wait_ms: float = 5.0, pad_batches: bool = True,
                 max_body_mb: float = 256.0):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.max_body = int(max_body_mb * (1 << 20))
        self.pad_batches = pad_batches
        self.queue: "Queue[_Request]" = Queue()
        # other-bucket requests set aside while a group forms (the batcher
        # owns it; _fail_pending may drain it on shutdown)
        self._backlog: "deque[_Request]" = deque()
        self.stats = {
            "requests": 0, "batches": 0, "errors": 0,
            "batched_requests_max": 0, "latency_ms_sum": 0.0,
            "decode_ms_sum": 0.0,  # body read + npz decode, per request
            # submit() to the batcher closing the request's group
            "queue_wait_ms_sum": 0.0,
        }
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._threads: List[threading.Thread] = []

    # -- request intake (handler threads) ---------------------------------- #
    def validate(self, feats, ntypes, pixels) -> Optional[str]:
        """Why a decoded request cannot be served, or None; checked per
        request so one bad payload fails alone, not its group."""
        pred = self.predictor
        if pixels is not None:
            if not pred.pixels_enabled:
                return ("server not configured for pixel requests (no "
                        "featurizer attached)")
            ps = pred._patch_size
            if (pixels.ndim != 4 or pixels.shape[0] == 0
                    or pixels.shape[1:] != (ps, ps, 3)):
                return f"pixels must be [N, {ps}, {ps}, 3]"
            if pixels.dtype not in (np.uint8, np.float32):
                return "pixels must be uint8 or float32"
            return None
        if feats.ndim != 2 or feats.shape[0] == 0:
            return "features must be [N, D]"
        if feats.shape[1] != pred.in_dim:
            return (f"feature dim {feats.shape[1]} != model in_dim "
                    f"{pred.in_dim}")
        if ntypes is not None:
            if ntypes.ndim != 1 or len(ntypes) != len(feats):
                return "node_types must be [N] matching features"
            # an out-of-range id would index past the type tables
            if int(ntypes.min()) < 0 or int(ntypes.max()) >= pred.n_node_types:
                return f"node_types must be in [0, {pred.n_node_types})"
        return None

    def submit(self, req: _Request) -> None:
        """Queue `req` and wait until the batcher (or shutdown) completes
        it."""
        req.enqueued = time.perf_counter()
        self.queue.put(req)
        if self._stop.is_set():
            # raced with shutdown: the batcher's drain may already have run
            self._fail_pending("server stopped")
        req.event.wait()

    # -- the batcher ------------------------------------------------------- #
    def _fail_pending(self, msg: str) -> None:
        """Complete every queued or set-aside request with an error, so no
        handler thread waits forever (idempotent)."""
        while True:
            r = self._pop_backlog()
            if r is None:
                break
            r.error = msg
            r.event.set()
        while True:
            try:
                r = self.queue.get_nowait()
            except Empty:
                break
            r.error = msg
            r.event.set()

    def _pop_backlog(self) -> Optional[_Request]:
        # _fail_pending may drain the backlog concurrently during shutdown
        try:
            return self._backlog.popleft()
        except IndexError:
            return None

    def _batcher(self) -> None:
        try:
            while not self._stop.is_set():
                self._batch_once()
        finally:
            self._stop.set()
            self._fail_pending("server stopped")

    def _batch_once(self) -> None:
        first = self._pop_backlog()
        if first is None:
            try:
                first = self.queue.get(timeout=0.1)
            except Empty:
                return
        group = [first]
        try:
            skipped: List[_Request] = []
            deadline = time.perf_counter() + self.max_wait
            while len(group) < self.max_batch:
                # same-bucket requests set aside earlier come first
                while len(group) < self.max_batch:
                    r = self._pop_backlog()
                    if r is None:
                        break
                    (group if r.bucket == first.bucket else skipped).append(r)
                if len(group) >= self.max_batch:
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    r = self.queue.get(timeout=remaining)
                except Empty:
                    break
                (group if r.bucket == first.bucket else skipped).append(r)
            # other-bucket arrivals keep their order for the next round
            self._backlog.extendleft(reversed(skipped))
            taken = time.perf_counter()
            with self._stats_lock:
                self.stats["queue_wait_ms_sum"] += sum(
                    taken - r.enqueued for r in group) * 1e3
            try:
                if first.pixels is not None:
                    # featurize each slide, then the feature path; padding
                    # repeats features, never pixels
                    slides = [self.predictor.featurize(r.pixels)
                              for r in group]
                else:
                    slides = [(r.features, r.node_types) for r in group]
                if self.pad_batches and len(slides) < self.max_batch:
                    slides += [slides[0]] * (self.max_batch - len(slides))
                probs = self.predictor.predict_many(slides)[:len(group)]
                for r, p in zip(group, probs):
                    r.probs = p
            except Exception as e:  # the group's error goes to each waiter
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["batched_requests_max"] = max(
                    self.stats["batched_requests_max"], len(group))
        finally:
            # every grouped request completes, even when a BaseException
            # (KeyboardInterrupt on a main-thread batcher) ends the round
            for r in group:
                if r.probs is None and r.error is None:
                    r.error = "server error"
                r.event.set()

    # -- lifecycle ----------------------------------------------------------- #
    def warmup(self, n_patches: int, feat_dim: Optional[int] = None,
               pixels: bool = False) -> None:
        """Run the shapes this server dispatches (batch max_batch, as
        pad_batches pads every group) before serving; pixels=True also
        runs one encoder chunk."""
        if pixels:
            self.predictor.warmup_pixels(n_patches,
                                         batch_sizes=(self.max_batch,))
        else:
            self.predictor.warmup(n_patches, feat_dim=feat_dim,
                                  batch_sizes=(self.max_batch,))

    def start(self) -> None:
        """The batcher and the accept loop in background threads."""
        for target in (self._batcher, self.httpd.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # httpd.shutdown() waits for serve_forever(), forever if it never
        # ran
        if self._threads:
            self.httpd.shutdown()
        self.httpd.server_close()
        self._fail_pending("server stopped")
        for t in self._threads:
            t.join(timeout=10)

    def serve_forever(self) -> None:
        """Blocking: the accept loop in a background thread, the batcher
        (all device work) on the calling thread, until interrupted."""
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        try:
            self._batcher()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def _make_handler(server: BatchingServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "model_version": server.predictor.version})
            elif self.path == "/stats":
                with server._stats_lock:
                    self._reply(200, dict(server.stats))
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "not found"})
                return
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0:
                # a negative length would make read() block until EOF
                self._reply(400, {"error": "bad Content-Length"})
                return
            if length > server.max_body:
                self._reply(413, {"error": f"body {length} bytes exceeds "
                                           f"limit {server.max_body}"})
                return
            t_dec = time.perf_counter()
            try:
                with np.load(io.BytesIO(self.rfile.read(length)),
                             allow_pickle=False) as z:
                    pixels = feats = ntypes = None
                    if "pixels" in z:
                        pixels = np.asarray(z["pixels"])
                    else:
                        feats = np.asarray(z["features"], np.float32)
                        ntypes = (np.asarray(z["node_types"], np.int32)
                                  if "node_types" in z else None)
            except Exception as e:  # any undecodable body is the client's
                self._reply(400, {"error": f"bad request: {e}"})
                return
            with server._stats_lock:
                server.stats["decode_ms_sum"] += (
                    time.perf_counter() - t_dec) * 1e3
            problem = server.validate(feats, ntypes, pixels)
            if problem is not None:
                self._reply(400, {"error": problem})
                return
            if server._stop.is_set():
                self._reply(503, {"error": "server stopping"})
                return
            req = _Request(feats, ntypes, pixels=pixels)
            server.submit(req)
            dt = (time.perf_counter() - t0) * 1e3
            with server._stats_lock:
                server.stats["requests"] += 1
                server.stats["latency_ms_sum"] += dt
                server.stats["errors"] += int(req.error is not None)
            if req.error is not None:
                self._reply(500, {"error": req.error})
            else:
                self._reply(200, {"probs": [float(p) for p in req.probs],
                                  "pred": int(np.argmax(req.probs)),
                                  "latency_ms": round(dt, 2)})

    return Handler
