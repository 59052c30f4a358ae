"""Slide -> graph construction (counterpart of
wsi_hgnn_tpu/pipeline/construct.py): the reference GraphConstructor and
get_graph.py CONSTRUCT loop.

Per slide: load its patch directory, run the encoder for 1024-d features
and PanNuke node types, build the KNN/Pearson graph on the device (the
CUDA KNN kernel on the card, one launch per slide), and write the
reference's three outputs under out_dir: heterogeneous/<slide>.npz,
homogeneous/<slide>.npz and node_types/<slide>.npy.

Encoders are callables `(patches [B, 256, 256, 3] f32 in [0, 1], or raw
uint8 when the encoder sets .accepts_uint8) -> (features [B, D],
node_types [B] | None)`: 'kimia', 'efficientnet-b4' and 'uni2-h' (with
inline HoVer-Net typing) and 'hover' (HoVer-Net fc1 features and types),
all models.featurizers.make_cnn_encoder; 'random' (tests); 'precomputed'
(<slide>.features.npz on disk). One encoder serves a whole run.
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import save_graph_npz
from ..graph.build import build_graph
from ..profiling import GLOBAL_TIMER
from ..utils import resolve_device
from .patches import iter_patch_batches, list_patches

EncoderFn = Callable[[np.ndarray], Tuple[np.ndarray, Optional[np.ndarray]]]


def random_encoder(dim: int = 1024, seed: int = 0, n_types: int = 6
                   ) -> EncoderFn:
    """Deterministic pseudo-featurizer for tests (a hash of each patch's
    pixel sum seeds its features and type)."""
    def fn(patches: np.ndarray):
        b = patches.shape[0]
        feats = np.empty((b, dim), np.float32)
        types = np.empty((b,), np.int32)
        for i in range(b):
            h = int(np.abs(patches[i]).sum() * 1000) % (2**31)
            r = np.random.RandomState((seed + h) % (2**31))
            feats[i] = r.randn(dim)
            types[i] = r.randint(0, n_types)
        return feats, types
    return fn


def encoder_mesh(config: Dict, device: torch.device):
    """The cards the CNN encoders shard each patch chunk over
    (`dp_devices`: "all" by default, an int count, or 1/0/null for one),
    as a tuple of devices; None when that is one device (or the CPU).
    The reference wraps both constructor CNNs in DataParallel; the JAX
    package shards them over its mesh."""
    dp = config.get("dp_devices", "all")
    if dp in (None, 0, 1, "0", "1") or device.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if dp != "all":
        n = min(int(dp), n)
    if n <= 1:
        return None
    return tuple(torch.device("cuda", i) for i in range(n))


CNN_ENCODERS = ("kimia", "efficientnet-b4", "uni2-h", "hover")


def check_encoder(config: Dict) -> None:
    """Raise for an encoder name outside the registry ('efficientnet-b7',
    which the JAX package does not build either). construct_all checks
    this before its loop, whose per-slide skip would otherwise turn the
    error into a run that writes nothing."""
    name = config["encoder_name"]
    if name not in ("random", "precomputed") + CNN_ENCODERS:
        raise NotImplementedError(f"encoder {name!r}")


def make_encoder(name: str, config: Dict, hovernet_config: Dict,
                 kimianet_config: Dict, with_typing: bool = False,
                 pad_batch_to: Optional[int] = None,
                 device=None, devices=None) -> EncoderFn:
    """The encoder registry of the reference constructor's dispatch on
    `encoder_name`: 'random', or a patch encoder ('kimia',
    'efficientnet-b4', 'uni2-h', 'hover'; with_typing adds HoVer-Net
    typing over the same patch chunk to the first three). pad_batch_to
    pads every chunk to one batch size; `devices` shards each chunk over
    several cards."""
    if name == "random":
        return random_encoder(config.get("feature_dim", 1024),
                              n_types=config.get("n_node_type", 6))
    if name in CNN_ENCODERS:
        from ..models.featurizers import make_cnn_encoder

        return make_cnn_encoder(name, config, hovernet_config,
                                kimianet_config, with_typing=with_typing,
                                pad_batch_to=pad_batch_to, device=device,
                                devices=devices)
    raise NotImplementedError(f"encoder {name!r}")


def build_default_encoder(config: Dict, hovernet_config: Dict,
                          kimianet_config: Dict,
                          device=None) -> Optional[EncoderFn]:
    """The encoder a GraphConstructor builds for this config, made once per
    run ('precomputed' needs none). HoVer-Net typing runs inline beside
    KimiaNet, EfficientNet or UNI2-h whenever no node_type_dir is given,
    as in the reference constructor; `inline_typing: false` opts out
    ('hover' types the patches itself). Chunks are padded to the hovernet batch_size."""
    enc_name = config["encoder_name"]
    if enc_name == "precomputed":
        return None
    want_typing = (enc_name in ("kimia", "efficientnet-b4", "uni2-h")
                   and config.get("node_type_dir") is None
                   and bool(config.get("inline_typing", True)))
    check_encoder(config)
    batch = int(hovernet_config.get("batch_size", 32) or 32)
    return make_encoder(enc_name, config, hovernet_config, kimianet_config,
                        with_typing=want_typing, pad_batch_to=batch,
                        device=device,
                        devices=encoder_mesh(config, resolve_device(device)))


class GraphConstructor:
    """The reference constructor contract: (graph_config, hovernet_config,
    kimianet_config, wsi_patch_dir) -> .construct_graph() -> (het_graph,
    homo_graph, node_types). Graphs are built on `device`."""

    def __init__(self, config: Dict, hovernet_config: Dict,
                 kimianet_config: Dict, wsi_data,
                 encoder: Optional[EncoderFn] = None, device=None):
        self.config = config
        self.radius = config["radius"]
        self.n_node_type = config.get("n_node_type", 6)
        self.wsi_data = wsi_data
        self.device = resolve_device(device)

        enc_name = config["encoder_name"]
        node_type_dir = config.get("node_type_dir")
        if encoder is None:
            encoder = build_default_encoder(config, hovernet_config,
                                            kimianet_config, self.device)

        if enc_name == "precomputed":
            z = np.load(str(wsi_data) + ".features.npz")
            self.features = z["features"].astype(np.float32)
            self.node_type = z.get("node_types",
                                   np.zeros(len(self.features), np.int32))
        else:
            feats, types = [], []
            paths = list_patches(wsi_data)
            if not paths:
                raise FileNotFoundError(f"no patches under {wsi_data}")
            batch = int(hovernet_config.get("batch_size", 32) or 32)
            # 0 = one prefetch thread; N = an N-process decode pool;
            # "auto" = one per host core but one (left for the device
            # dispatch thread)
            workers = self.config.get("decode_workers", 0)
            if workers == "auto":
                workers = max((os.cpu_count() or 1) - 1, 0)
            out_dtype = ("uint8" if getattr(encoder, "accepts_uint8", False)
                         else "float32")
            it = iter_patch_batches(
                paths, batch, decode_workers=int(workers or 0),
                timer=GLOBAL_TIMER, timer_stage="construct/decode",
                out_dtype=out_dtype)
            sentinel = object()
            while True:
                # under construct_all these nest as
                # construct/featurize/{patch_wait,encode}; the decode work
                # itself is booked under construct/decode (overlapped)
                with GLOBAL_TIMER.stage("patch_wait"):
                    pb = next(it, sentinel)
                if pb is sentinel:
                    break
                with GLOBAL_TIMER.stage("encode"):
                    f, t = encoder(pb)
                feats.append(f)
                types.append(t if t is not None
                             else np.zeros(len(f), np.int32))
            self.features = np.concatenate(feats)
            self.node_type = np.concatenate(types)

        # node types may instead come from an earlier HoVer-Net pass on disk
        if node_type_dir and enc_name != "hover":
            tail = os.path.split(str(wsi_data))[1]
            f = Path(node_type_dir) / (tail + ".npy")
            if f.exists():
                loaded = np.load(f)
                if len(loaded) != len(self.features):
                    raise ValueError(
                        f"stale node_type_dir: {f} holds {len(loaded)} types "
                        f"but {tail!r} has {len(self.features)} patches; "
                        "re-run the HoVer-Net typing pass")
                self.node_type = loaded
            else:
                warnings.warn(
                    f"node_type_dir is set but {f} does not exist; node "
                    f"types for {tail!r} stay as computed/zero")
        if (self.n_node_type > 1 and len(self.node_type)
                and not np.any(self.node_type)):
            warnings.warn(
                f"all node types are 0 for {wsi_data!r}: the heterogeneous "
                "graph is degenerate. Provide node_type_dir or enable "
                "inline_typing.")

    def construct_graph(self):
        het, homo = build_graph(
            self.features, self.node_type, radius=self.radius,
            n_node_types=self.n_node_type,
            knn_impl=self.config.get("knn_impl", "exact"),
            device=self.device)
        return het, homo, self.node_type


def _dump(g, path, is_hetero: bool) -> None:
    n = int(np.asarray(g.node_mask).sum())
    e = int(np.asarray(g.edge_mask).sum())
    save_graph_npz(path, np.asarray(g.feat)[:n], np.asarray(g.src)[:e],
                   np.asarray(g.dst)[:e],
                   node_type=np.asarray(g.node_type)[:n],
                   esign=np.asarray(g.esign)[:e], sim=np.asarray(g.sim)[:e],
                   n_node_types=g.n_node_types, is_hetero=is_hetero)


def construct_all(graph_config: Dict, hovernet_config: Dict,
                  kimianet_config: Dict, encoder: Optional[EncoderFn] = None,
                  verbose: bool = True, device=None) -> int:
    """The get_graph.py CONSTRUCT loop: every slide patch directory under
    patch_path (`patch_path*/*`), slides whose outputs exist skipped, and
    a slide whose construction fails skipped with a message (the
    reference's robustness by skip). Returns the number of slides
    written. Stages: construct/{encoder_init, featurize, graph, save,
    decode} in profiling.GLOBAL_TIMER."""
    import glob as _glob

    dev = resolve_device(device)
    if encoder is None:
        check_encoder(graph_config)
    out_dir = Path(graph_config["out_dir"])
    for kind in ("heterogeneous", "homogeneous", "node_types"):
        (out_dir / kind).mkdir(parents=True, exist_ok=True)
    patch_dirs = sorted(_glob.glob(str(graph_config["patch_path"]) + "*/*"))

    def get_encoder():
        # one encoder for the run, built lazily: a re-run whose outputs
        # all exist builds no CNN
        nonlocal encoder
        if encoder is None:
            with GLOBAL_TIMER.stage("construct/encoder_init"):
                encoder = build_default_encoder(
                    graph_config, hovernet_config, kimianet_config, dev)
        return encoder

    written = 0
    for i, wsi_input in enumerate(patch_dirs):
        if verbose:
            print(f"Processing {i + 1} / {len(patch_dirs)}")
        try:
            tail = os.path.split(wsi_input)[1]
            het_file = out_dir / "heterogeneous" / (tail + ".npz")
            homo_file = out_dir / "homogeneous" / (tail + ".npz")
            if het_file.exists() or homo_file.exists():
                continue
            with GLOBAL_TIMER.stage("construct/featurize"):
                gc = GraphConstructor(graph_config, hovernet_config,
                                      kimianet_config, wsi_input,
                                      encoder=get_encoder(), device=dev)
            with GLOBAL_TIMER.stage("construct/graph"):
                het, homo, node_type = gc.construct_graph()
            with GLOBAL_TIMER.stage("construct/save"):
                _dump(het, het_file, True)
                _dump(homo, homo_file, False)
                np.save(out_dir / "node_types" / (tail + ".npy"), node_type)
            written += 1
            if verbose:
                print(f"Graphs saved for {tail}")
        except (ValueError, KeyError, IndexError, RuntimeError,
                FileNotFoundError) as e:
            if verbose:
                print(f"Failed to construct graph ({e}), moves to next WSI "
                      "image")
    return written
