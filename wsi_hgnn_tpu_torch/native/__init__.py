"""The native host packer (counterpart of wsi_hgnn_tpu/native): the C++
graph batcher and edge sort of `wsipack.cpp`, bound with ctypes.

`wsipack.cpp` has a plain C interface (no Python headers) and is compiled
by `g++ -O3 -shared -fPIC -std=c++17 -pthread` at first use into
`build/native/libwsipack-<source hash>.so` inside the checkout (the
directory is listed in .gitignore), the way `kernels/_build.py` builds
the CUDA kernels. A build that fails raises: nothing falls back to the
numpy path on its own (graph/batch.py chooses that path by an argument).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "wsipack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def lib_path() -> Path:
    digest = hashlib.sha1(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libwsipack-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile wsipack.cpp unless this source's library exists; returns
    its path. A concurrent build never sees half a file (each compiles to
    its own temporary and renames it into place)."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native packer builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every entry
    point's argument and result types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.wsipack_batch.restype = ctypes.c_int
            lib.wsipack_batch.argtypes = [
                ctypes.c_int64, _i64p, _i64p,
                ctypes.POINTER(_f32p), ctypes.POINTER(_i32p),
                ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
                ctypes.POINTER(_i32p), ctypes.POINTER(_f32p),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _f32p, _i32p, _i32p, _u8p, _i32p, _i32p, _i32p, _f32p, _u8p,
                ctypes.c_int32]
            lib.wsipack_sort_edges.restype = ctypes.c_int
            lib.wsipack_sort_edges.argtypes = [ctypes.c_int64, _i64p,
                                               ctypes.c_int64, _i64p]
            _lib = lib
        return _lib


def _ptrs(arrays: List[np.ndarray], ptr_t):
    out = (ptr_t * len(arrays))()
    for i, a in enumerate(arrays):
        out[i] = a.ctypes.data_as(ptr_t)
    return out


def pack_batch_native(feats: Sequence[np.ndarray],
                      node_types: Sequence[np.ndarray],
                      srcs: Sequence[np.ndarray], dsts: Sequence[np.ndarray],
                      esigns: Sequence[np.ndarray],
                      sims: Sequence[np.ndarray], cap_nodes: int,
                      cap_edges: int, n_threads: int = 0
                      ) -> Tuple[np.ndarray, ...]:
    """Pack per-graph arrays (node indices local to each graph) into
    padded batch buffers in one multithreaded C++ pass: (feat [cap_nodes,
    D] f32, node_type, node_graph, node_mask, src, dst (offset to the
    batch), esign, sim, edge_mask), zeros in the padding. Shapes are
    checked here, before any pointer reaches C++; a batch over the
    capacities raises ValueError."""
    b = len(feats)
    d = feats[0].shape[1]
    for i in range(b):
        if feats[i].ndim != 2 or feats[i].shape[1] != d:
            raise ValueError(
                f"graph {i}: feature dim {feats[i].shape} != [*, {d}]: all "
                "graphs in a batch must share one feature dimension")
        n_i, e_i = feats[i].shape[0], srcs[i].shape[0]
        if (node_types[i].shape[0] != n_i or dsts[i].shape[0] != e_i
                or esigns[i].shape[0] != e_i or sims[i].shape[0] != e_i):
            raise ValueError(f"graph {i}: inconsistent node/edge array "
                             "lengths")
    # contiguous copies of the right dtypes, referenced until the call ends
    feats = [np.ascontiguousarray(f, np.float32) for f in feats]
    node_types = [np.ascontiguousarray(t, np.int32) for t in node_types]
    srcs = [np.ascontiguousarray(s, np.int32) for s in srcs]
    dsts = [np.ascontiguousarray(s, np.int32) for s in dsts]
    esigns = [np.ascontiguousarray(s, np.int32) for s in esigns]
    sims = [np.ascontiguousarray(s, np.float32) for s in sims]
    n_nodes = np.asarray([f.shape[0] for f in feats], np.int64)
    n_edges = np.asarray([s.shape[0] for s in srcs], np.int64)

    out_feat = np.empty((cap_nodes, d), np.float32)
    out_ntype = np.empty(cap_nodes, np.int32)
    out_ngraph = np.empty(cap_nodes, np.int32)
    out_nmask = np.empty(cap_nodes, np.uint8)
    out_src = np.empty(cap_edges, np.int32)
    out_dst = np.empty(cap_edges, np.int32)
    out_esign = np.empty(cap_edges, np.int32)
    out_sim = np.empty(cap_edges, np.float32)
    out_emask = np.empty(cap_edges, np.uint8)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, b)

    rc = get_lib().wsipack_batch(
        b, n_nodes.ctypes.data_as(_i64p), n_edges.ctypes.data_as(_i64p),
        _ptrs(feats, _f32p), _ptrs(node_types, _i32p), _ptrs(srcs, _i32p),
        _ptrs(dsts, _i32p), _ptrs(esigns, _i32p), _ptrs(sims, _f32p),
        d, cap_nodes, cap_edges,
        out_feat.ctypes.data_as(_f32p), out_ntype.ctypes.data_as(_i32p),
        out_ngraph.ctypes.data_as(_i32p), out_nmask.ctypes.data_as(_u8p),
        out_src.ctypes.data_as(_i32p), out_dst.ctypes.data_as(_i32p),
        out_esign.ctypes.data_as(_i32p), out_sim.ctypes.data_as(_f32p),
        out_emask.ctypes.data_as(_u8p), n_threads)
    if rc != 0:
        raise ValueError("batch exceeds requested capacity")
    return (out_feat, out_ntype, out_ngraph, out_nmask.astype(bool),
            out_src, out_dst, out_esign, out_sim, out_emask.astype(bool))


def sort_edges_native(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """The stable counting-sort permutation of edge keys in [0, n_keys):
    keys[perm] is non-decreasing, equal keys in their first order. A key
    out of range raises ValueError."""
    keys = np.ascontiguousarray(keys, np.int64)
    perm = np.empty(len(keys), np.int64)
    rc = get_lib().wsipack_sort_edges(len(keys), keys.ctypes.data_as(_i64p),
                                      n_keys, perm.ctypes.data_as(_i64p))
    if rc != 0:
        raise ValueError("edge keys out of range")
    return perm
