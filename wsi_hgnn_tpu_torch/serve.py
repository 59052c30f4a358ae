"""Slide-to-prediction serving (counterpart of the pixels-in lattice path
of wsi_hgnn_tpu/serve.py::SlidePredictor).

A request carries patch features [N, D] (+ node types), or raw patch
pixels once `enable_pixels` attached the two-CNN encoder (KimiaNet
features + HoVer-Net typing over one patch stream). Slides of a group are
padded to one size bucket; the KNN + Pearson lattice is built on the
device and the lattice HEAT model answers with softmax probabilities.
Occupancy is per slide (presence='graph'), so a response never depends on
which other requests share its group.

Not ported yet (ROADMAP.md): reading flax-msgpack checkpoints (pass
`variables=`), the TypedGraph serving path for models without a lattice
twin, and the micro-batching HTTP server.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import convert
from .config import parse_lattice_twin
from .graph.typed_graph import bucket_size
from .models.lattice import build_lattice_device
from .utils import resolve_device, set_cuda_numerics, to_numpy, to_torch


class SlidePredictor:
    """Serves per-slide predictions of a trained lattice HEAT model.

    `config` is the training config dict (its GNN section picks the
    model); `variables` is the model's flax-layout variable tree as numpy
    arrays. The predictor runs on `device` ('cuda' unless the caller asks
    for 'cpu')."""

    def __init__(self, config: Dict, radius: int = 9, n_node_types: int = 6,
                 checkpoint_path: Optional[str] = None,
                 knn_impl: str = "exact", variables: Optional[Dict] = None,
                 device=None):
        if variables is None or checkpoint_path is not None:
            raise NotImplementedError(
                "reading flax-msgpack checkpoints is not ported yet "
                "(ROADMAP.md); pass the variable tree as variables=")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_cuda_numerics()
        model = parse_lattice_twin(config["GNN"])
        if model is None:
            raise NotImplementedError(
                f"{config['GNN']['name']!r} has no lattice twin; the "
                "TypedGraph serving path is not ported yet (ROADMAP.md)")
        model.presence = "graph"  # per-slide occupancy: grouping-invariant
        convert.load_flax_variables(model, variables)
        self.model = model.to(self.device).eval()
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
        (first kernel build, allocator growth) is booked to compile_ms."""
        self.timing = {
            "pack_ms": 0.0, "lock_wait_ms": 0.0, "device_ms": 0.0,
            "compile_ms": 0.0, "calls": 0, "cold_calls": 0,
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
                      seed: int = 0) -> None:
        """Attach a patch-pixel featurizer: by default the fused two-CNN
        encoder at the constructor's chunk size (hovernet_config
        batch_size, default 128). `encoder` injects a custom
        `(patches) -> (features, node_types)` callable."""
        hovernet_config = dict(hovernet_config or {})
        if chunk is None:
            chunk = int(hovernet_config.get("batch_size", 128) or 128)
        if encoder is None:
            from .models.featurizers import make_cnn_encoder

            encoder = make_cnn_encoder(
                encoder_name,
                {"feature_dim": self.in_dim, "n_node_type": self.n_node_types},
                hovernet_config, dict(kimianet_config or {}),
                with_typing=True, pad_batch_to=chunk, device=self.device,
                kimia_variables=kimia_variables,
                hover_variables=hover_variables, seed=seed)
        self._encoder = encoder
        self._patch_size = int(patch_size)
        self._chunk = int(chunk)

    @property
    def pixels_enabled(self) -> bool:
        return self._encoder is not None

    def featurize(self, pixels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Patch pixels [N, P, P, 3] (uint8, or f32 in [0, 1]) -> (features
        [N, D] f32, node_types [N] int32), chunk by chunk."""
        if not self.pixels_enabled:
            raise RuntimeError("pixels not enabled: call enable_pixels()")
        px = np.asarray(pixels)
        if px.dtype == np.uint8:
            if not getattr(self._encoder, "accepts_uint8", False):
                px = px.astype(np.float32) / 255.0
        else:
            px = px.astype(np.float32)
        feats, types = [], []
        with self._lock:
            t0 = time.perf_counter()
            for i in range(0, len(px), self._chunk):
                f, t = self._encoder(px[i:i + self._chunk])
                feats.append(np.asarray(f, np.float32))
                types.append(np.zeros(len(f), np.int32) if t is None
                             else np.asarray(t, np.int32))
                self.timing["featurize_chunks"] += 1
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

    def predict_many(self, slides: Sequence[Tuple[np.ndarray,
                                                  Optional[np.ndarray]]]
                     ) -> np.ndarray:
        """[(features [N_i, D], node_types [N_i] | None)] -> probs [B, C],
        one device call for the whole group."""
        t0 = time.perf_counter()
        feats, ntypes, mask = self.pack(slides)
        t1 = time.perf_counter()
        with self._lock:
            t2 = time.perf_counter()
            key = feats.shape[:2]
            cold = key not in self._warm_keys
            with torch.inference_mode():
                g = build_lattice_device(
                    to_torch(feats, self.device), to_torch(ntypes, self.device),
                    to_torch(mask, self.device), self.radius,
                    self.n_node_types, knn_impl=self.knn_impl)
                probs = to_numpy(torch.softmax(self.model(g), dim=-1))
            t3 = time.perf_counter()
            self._warm_keys.add(key)
            self.timing["pack_ms"] += (t1 - t0) * 1e3
            self.timing["lock_wait_ms"] += (t2 - t1) * 1e3
            self.timing["compile_ms" if cold else "device_ms"] += (t3 - t2) * 1e3
            self.timing["calls"] += 1
            self.timing["cold_calls"] += int(cold)
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
