"""Host-side patch loading for graph construction (counterpart of
wsi_hgnn_tpu/pipeline/patches.py; a copy, so the port imports nothing of
the JAX package): read every patch image of one slide's directory, resize
to 256 as torchvision's Resize(256) does, batch for the featurizer.

Batches stream to the device featurizer through a double-buffered
prefetch thread (decode_workers=0) or a multi-process decode pool
(decode_workers>0). Both yield identical batches, and a corrupt patch
raises in the consumer on both.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np


def list_patches(wsi_dir) -> List[Path]:
    """All files of one slide's patch directory, sorted for determinism
    (the reference's glob order is filesystem-dependent)."""
    return sorted(p for p in Path(wsi_dir).glob("*") if p.is_file())


def _load_patch_u8(path, size: int = 256) -> np.ndarray:
    """[size, size, 3] uint8 (decode + torchvision-Resize analog; float
    scaling happens once per batch so the decode pool ships 4x fewer
    bytes over its result pipe)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    # torchvision Resize(256) scales the SHORT side to 256, keeping aspect,
    # with BILINEAR resampling (InterpolationMode.BILINEAR is torchvision's
    # default — PIL's own default is BICUBIC, which decodes non-256 patches
    # to different pixels than the reference)
    if min(w, h) != size:
        if w < h:
            img = img.resize((size, int(round(h * size / w))),
                             Image.Resampling.BILINEAR)
        else:
            img = img.resize((int(round(w * size / h)), size),
                             Image.Resampling.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    # center-crop to square if the aspect wasn't 1:1 — deliberate deviation
    # for static shapes: the reference keeps the full resized image, but
    # its own DataLoader could not stack mixed sizes either (in practice
    # every tiled patch is already square)
    hh, ww = arr.shape[:2]
    if hh != size or ww != size:
        top = (hh - size) // 2
        left = (ww - size) // 2
        arr = arr[top : top + size, left : left + size]
    return arr


def load_patch(path, size: int = 256) -> np.ndarray:
    """[size, size, 3] float32 in [0,1] (torchvision Resize+ToTensor analog,
    channel-last, the encoders' input layout)."""
    return _load_patch_u8(path, size).astype(np.float32) / 255.0


def _decode_batch_u8(path_strs: List[str], size: int):
    """Pool worker: decode one batch, returning (uint8 stack, decode s).
    The wall time rides back with the data so overlapped decode work is
    still attributable (profiling.StageTimer.add)."""
    t0 = time.perf_counter()
    arr = np.stack([_load_patch_u8(p, size) for p in path_strs])
    return arr, time.perf_counter() - t0


def _iter_pooled(paths, chunks, size, prefetch, decode_workers, timer,
                 timer_stage, out_dtype):
    """Multi-process decode: per-batch tasks on a fork pool, bounded at
    decode_workers + prefetch outstanding batches (an unbounded imap would
    buffer a whole slide's decoded pixels — ~1.6 GB at 2048 patches)."""
    import multiprocessing as mp
    from collections import deque

    # never plain fork: this process has threads (torch's, the prefetch
    # thread), and forking them is deadlock-prone; forkserver workers fork
    # from a clean single-threaded server process, spawn ones start fresh
    methods = mp.get_all_start_methods()
    method = "forkserver" if "forkserver" in methods else "spawn"
    ctx = mp.get_context(method)
    if method == "forkserver":
        # the server imports this module (numpy+PIL, ~0.7 s) ONCE; every
        # per-slide pool then forks workers that inherit it — without the
        # preload each worker re-imports per slide, on the same cores the
        # decode itself needs. No-op once the server is already running.
        ctx.set_forkserver_preload([__name__])
    max_out = decode_workers + max(int(prefetch), 1)
    chunk_iter = iter(chunks)
    with ctx.Pool(decode_workers) as pool:
        def submit():
            c = next(chunk_iter, None)
            if c is None:
                return False
            pending.append(pool.apply_async(
                _decode_batch_u8, ([str(paths[i]) for i in c], size)
            ))
            return True

        pending: deque = deque()
        for _ in range(max_out):
            if not submit():
                break
        while pending:
            arr_u8, dt = pending.popleft().get()  # worker errors re-raise
            submit()
            if timer is not None:
                timer.add(timer_stage, dt)
            yield (arr_u8 if out_dtype == "uint8"
                   else arr_u8.astype(np.float32) / 255.0)


def iter_patch_batches(
    paths: List[Path],
    batch_size: int,
    size: int = 256,
    prefetch: int = 2,
    decode_workers: int = 0,
    timer=None,
    timer_stage: str = "decode",
    out_dtype: str = "float32",
) -> Iterator[np.ndarray]:
    """Yield [b, size, size, 3] batches with background decoding.

    decode_workers=0: one prefetch thread overlaps decode with device
    compute (enough when decode/batch < device/batch). decode_workers>0:
    a process pool decodes `decode_workers` batches concurrently, for
    hosts where single-thread JPEG decode bounds the pipeline. timer (a
    profiling.StageTimer) accumulates worker decode seconds under
    `timer_stage` even though the work is overlapped.

    out_dtype: 'float32' (default) scales to [0,1] on the host; 'uint8'
    yields raw decoded bytes for encoders that normalise on the device
    (encode.accepts_uint8): the host skips a 4x-bigger f32 copy and the
    device link carries 4x fewer bytes.
    """
    chunks = [
        list(range(i, min(i + batch_size, len(paths))))
        for i in range(0, len(paths), batch_size)
    ]
    if decode_workers and decode_workers > 0:
        yield from _iter_pooled(paths, chunks, size, prefetch,
                                int(decode_workers), timer, timer_stage,
                                out_dtype)
        return

    def make(idxs):
        t0 = time.perf_counter()
        arr = np.stack([_load_patch_u8(paths[i], size) for i in idxs])
        out = arr if out_dtype == "uint8" else arr.astype(np.float32) / 255.0
        if timer is not None:
            timer.add(timer_stage, time.perf_counter() - t0)
        return out

    # a corrupt patch must RAISE, not silently truncate the stream — a
    # graph built from a partial patch set would save without warning
    # (prefetched_batches re-raises worker exceptions in the consumer)
    from ..data.loader import prefetched_batches

    yield from prefetched_batches(chunks, make, prefetch)
