"""Whole-slide tiling (counterpart of wsi_hgnn_tpu/pipeline/tiler.py, the
reference's get_patches.py): host code, numpy and PIL only.

  * DeepZoom pyramid tiling at 1-2 magnification levels chosen relative to
    the slide's objective power;
  * background rejection by the FIND_EDGES mean-edge statistic against a
    threshold;
  * `{col}_{row}.<ext>` tile names and the per-slide "bag" directories,
    2-level pyramids nesting high-mag tiles under their low-mag parent;
  * worker processes fed by a JoinableQueue. The JAX package's workers
    fork; these start with `spawn`, since a parent that has imported
    torch (or JAX) is multithreaded and fork is unsafe there. A worker
    imports this module alone (the pipeline package loads its modules
    lazily), not torch.

Backends: openslide's DeepZoomGenerator when the library imports (real
.svs/.tif pyramids); otherwise a pure-PIL DeepZoom clone over any
PIL-readable image with the same level and tile addressing.
"""
from __future__ import annotations

import glob
import math
import multiprocessing
import os
import shutil
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter, ImageStat

try:  # openslide is a C library, optional
    import openslide
    from openslide import open_slide
    from openslide.deepzoom import DeepZoomGenerator as _OSDeepZoom

    HAVE_OPENSLIDE = True
except ImportError:
    HAVE_OPENSLIDE = False

_SPAWN = multiprocessing.get_context("spawn")


class PilDeepZoom:
    """Minimal DeepZoom generator over a PIL image: level L has dimensions
    ceil(dim / 2^(level_count-1-L)); tiles are tile_size squares, each
    extended by `overlap` px on every side that is not an image edge (as
    openslide's generator does)."""

    def __init__(self, image: Image.Image, tile_size: int, overlap: int = 0):
        self.image = image
        self.tile_size = tile_size
        self.overlap = overlap
        w, h = image.size
        self.level_count = int(math.ceil(math.log2(max(w, h)))) + 1
        self.level_dimensions = []
        for lv in range(self.level_count):
            scale = 2 ** (self.level_count - 1 - lv)
            self.level_dimensions.append(
                (max(1, int(math.ceil(w / scale))),
                 max(1, int(math.ceil(h / scale)))))
        self.level_tiles = [
            (int(math.ceil(dw / tile_size)), int(math.ceil(dh / tile_size)))
            for dw, dh in self.level_dimensions]
        self.tile_count = sum(c * r for c, r in self.level_tiles)
        self._cache_level: Optional[int] = None
        self._cache_img: Optional[Image.Image] = None

    def _level_image(self, level: int) -> Image.Image:
        if self._cache_level != level:
            self._cache_img = self.image.resize(self.level_dimensions[level])
            self._cache_level = level
        return self._cache_img

    def get_tile(self, level: int, address: Tuple[int, int]) -> Image.Image:
        col, row = address
        img = self._level_image(level)
        ts, ov = self.tile_size, self.overlap
        left = max(col * ts - ov, 0)
        top = max(row * ts - ov, 0)
        right = min((col + 1) * ts + ov, img.size[0])
        bottom = min((row + 1) * ts + ov, img.size[1])
        return img.crop((left, top, right, bottom))


def _open_dz(slidepath: str, tile_size: int, overlap: int,
             limit_bounds: bool):
    if HAVE_OPENSLIDE:
        slide = open_slide(slidepath)
        return slide, _OSDeepZoom(slide, tile_size, overlap,
                                  limit_bounds=limit_bounds)
    img = Image.open(slidepath).convert("RGB")
    return None, PilDeepZoom(img, tile_size, overlap)


def tile_is_foreground(tile: Image.Image, tile_size: int,
                       threshold: float) -> bool:
    """The FIND_EDGES mean-edge background filter."""
    edge = ImageStat.Stat(tile.filter(ImageFilter.FIND_EDGES)).sum
    return float(np.mean(edge)) / (tile_size ** 2) > threshold


class TileWorker(_SPAWN.Process):
    """A spawned worker writing the foreground tiles it is sent."""

    def __init__(self, q, slidepath, tile_size, overlap, limit_bounds,
                 quality, threshold):
        super().__init__(name="TileWorker", daemon=True)
        self._queue = q
        self._slidepath = slidepath
        self._tile_size = tile_size
        self._overlap = overlap
        self._limit_bounds = limit_bounds
        self._quality = quality
        self._threshold = threshold
        # a forked worker would inherit the parent's decompression-bomb
        # guard; a spawned one is handed it
        self._max_pixels = Image.MAX_IMAGE_PIXELS

    def run(self):
        Image.MAX_IMAGE_PIXELS = self._max_pixels
        # the slide opens after the first job arrives, so a worker that is
        # only told to stop (every level out of range) reads no pixels
        dz = None
        while True:
            data = self._queue.get()
            if data is None:
                self._queue.task_done()
                break
            if dz is None:
                _, dz = _open_dz(self._slidepath, self._tile_size,
                                 self._overlap, self._limit_bounds)
            level, address, outfile = data
            try:
                tile = dz.get_tile(level, address)
                if tile_is_foreground(tile, self._tile_size, self._threshold):
                    w, h = tile.size
                    if not (w == self._tile_size and h == self._tile_size):
                        tile = tile.resize((self._tile_size, self._tile_size))
                    tile.save(outfile, quality=self._quality)
            except Exception as e:  # skip and continue, as the reference
                print(f"tile {outfile} skipped: {e!r}", file=sys.stderr)
            self._queue.task_done()


class DeepZoomStaticTiler:
    """Whole-slide tiler: picks DeepZoom levels by target magnification
    relative to the slide's objective power and streams tile jobs to the
    worker pool; `run` returns when every tile is written and every worker
    has exited."""

    def __init__(self, slidepath, basename, mag_levels: Sequence[int],
                 base_mag: float, objective: float, fmt: str, tile_size: int,
                 overlap: int, limit_bounds: bool, quality: int, workers: int,
                 threshold: float):
        self._slidepath = slidepath
        self._basename = basename
        self._format = fmt
        self._tile_size = tile_size
        self._overlap = overlap
        self._mag_levels = list(mag_levels)
        self._base_mag = base_mag
        self._objective = objective
        self._limit_bounds = limit_bounds
        self._queue = _SPAWN.JoinableQueue(2 * workers)
        self._workers = [
            TileWorker(self._queue, slidepath, tile_size, overlap,
                       limit_bounds, quality, threshold)
            for _ in range(workers)]
        for w in self._workers:
            w.start()

    def run(self):
        try:
            self._enqueue()
        finally:
            self._shutdown()

    def _enqueue(self):
        slide, dz = _open_dz(self._slidepath, self._tile_size, self._overlap,
                             self._limit_bounds)
        mag_base = None
        if HAVE_OPENSLIDE and slide is not None:
            mag_base = slide.properties.get(
                openslide.PROPERTY_NAME_OBJECTIVE_POWER)
        if mag_base is None:
            mag_base = self._objective
        first_level = int(math.log2(float(mag_base) / self._base_mag))
        target_levels = [i + first_level for i in self._mag_levels]
        target_levels.reverse()

        dz_levels = [dz.level_count - i - 1 for i in target_levels]
        mag_list = [int(int(mag_base) / 2 ** i) for i in target_levels]
        for mag, level in zip(mag_list, dz_levels):
            if not 0 <= level < dz.level_count:
                # the reference skips levels the slide does not have
                print(f"skipping magnification {mag}: DeepZoom level "
                      f"{level} outside [0, {dz.level_count})",
                      file=sys.stderr)
                continue
            tiledir = os.path.join(f"{self._basename}_files", str(mag))
            os.makedirs(tiledir, exist_ok=True)
            cols, rows = dz.level_tiles[level]
            for row in range(rows):
                for col in range(cols):
                    tilename = os.path.join(tiledir,
                                            f"{col}_{row}.{self._format}")
                    if not os.path.exists(tilename):
                        self._queue.put((level, (col, row), tilename))

    def _shutdown(self):
        for _ in self._workers:
            self._queue.put(None)
        self._queue.join()
        for w in self._workers:
            w.join(timeout=60)


def nested_patches(img_slide: str, out_base: str, temp_base: str,
                   levels: Sequence[int] = (0,), ext: str = "jpeg",
                   class_index: int = 2) -> str:
    """Move the tiles into the slide's bag directory; 2-level pyramids nest
    high-mag tiles under their low-mag parent. A low-mag tile whose
    children were all rejected keeps its patch (the reference's removal
    targets an already-moved path and is swallowed). Returns the bag."""
    parts = img_slide.split(os.sep)
    img_name = parts[-1].split(".")[0]
    img_class = parts[class_index] if len(parts) > class_index else "default"
    bag_path = os.path.join(out_base, img_class, img_name)
    os.makedirs(bag_path, exist_ok=True)
    temp_files = f"{temp_base}_files"

    if len(levels) == 1:
        for patch in glob.glob(os.path.join(temp_files, "*", "*." + ext)):
            shutil.move(patch, os.path.join(bag_path, os.path.basename(patch)))
    else:
        level_factor = 2 ** int(levels[1] - levels[0])
        mags = sorted(int(os.path.basename(i))
                      for i in glob.glob(os.path.join(temp_files, "*")))
        low_patches = glob.glob(os.path.join(temp_files, str(mags[0]),
                                             "*." + ext))
        for low_patch in low_patches:
            name = os.path.basename(low_patch)
            shutil.move(low_patch, os.path.join(bag_path, name))
            folder = name.split(".")[0]
            high_dir = os.path.join(bag_path, folder)
            os.makedirs(high_dir, exist_ok=True)
            low_x, low_y = (int(v) for v in folder.split("_"))
            for x in range(low_x * level_factor, (low_x + 1) * level_factor):
                for y in range(low_y * level_factor,
                               (low_y + 1) * level_factor):
                    hp = os.path.join(temp_files, str(mags[1]),
                                      f"{x}_{y}.{ext}")
                    if os.path.exists(hp):
                        shutil.move(hp, os.path.join(high_dir,
                                                     os.path.basename(hp)))
            try:
                os.rmdir(high_dir)   # drop the folder if it has no child
            except OSError:
                pass
    return bag_path


def tile_slides(slides: Sequence[str], out_base: str, *, levels=(0,),
                base_mag=40.0, objective=20.0, fmt="jpeg", tile_size=256,
                overlap=0, quality=70, workers=4, background_t=15,
                class_index: int = 2) -> None:
    """The get_patches loop: tile each slide into a temporary DeepZoom tree
    in the working directory, move the tiles into bags, clean up."""
    # slides legitimately exceed PIL's decompression-bomb threshold; the
    # guard is lifted here, in the tiling entry, not at import
    Image.MAX_IMAGE_PIXELS = None
    temp_base = "WSI_temp_2" if len(levels) == 1 else "WSI_temp"
    for idx, c_slide in enumerate(slides):
        print(f"Process slide {idx + 1}/{len(slides)}")
        DeepZoomStaticTiler(c_slide, temp_base, levels, base_mag, objective,
                            fmt, tile_size, overlap, True, quality, workers,
                            background_t).run()
        nested_patches(c_slide, out_base, temp_base, levels, fmt, class_index)
        shutil.rmtree(f"{temp_base}_files", ignore_errors=True)
    print(f"Patch extraction done for {len(slides)} slides.")
