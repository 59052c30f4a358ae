"""In-memory WSI patch extractor (counterpart of
wsi_hgnn_tpu/pipeline/extractor.py), without OpenCV: numpy, scipy.ndimage
and PIL only. Host work; nothing of it runs on the card.

One slide level is read whole (openslide when installed, else PIL, a level
being repeated 2x downsampling); tissue is where the uint8 HSV image lies
in [20, 200] on all three channels; the mask is closed (15 x 15) and then
opened (5 x 5); the 5 largest external regions (by the area of their
traced outline) are scanned with a half-patch-stride window over their
bounding boxes; a full-size patch is kept when at least 25% of its pixels
are inside the filled regions and not black in grey. Returns (patches,
coords, mask).

Each OpenCV operation the JAX extractor calls has an exact counterpart:

  * COLOR_RGB2HSV on uint8: OpenCV's fixed-point tables (12 fractional
    bits, 255 << 12 / v for S, 180 << 12 / (6 diff) for H), so pixels near
    the 20/200 edges fall on the same side;
  * COLOR_RGB2GRAY on uint8: (9798 R + 19235 G + 3735 B + 16384) >> 15,
    OpenCV's 15-bit table (the 14-bit 4899/9617/1868 one of older
    releases rounds some colours differently);
  * morphologyEx CLOSE / OPEN with a square kernel: max/min filters whose
    border is ignored (dilation pads with the minimum, erosion with the
    maximum);
  * findContours(RETR_EXTERNAL): the 8-connected foreground components not
    enclosed by another, each outline traced by Suzuki's border following
    from its first pixel in raster order, returned in OpenCV's order (the
    reverse of that raster order); boundingRect is the component's box,
    contourArea the shoelace area of the traced outline;
  * drawContours(FILLED): the components with their holes (background
    regions 4-connected and cut off from the image's outside) filled.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

import numpy as np
from scipy import ndimage

HSV_SHIFT = 12
GRAY_SHIFT = 15
GRAY_RGB = (9798, 19235, 3735)
THRESH_LO, THRESH_HI = 20, 200
CLOSE_K, OPEN_K = 15, 5
N_REGIONS = 5
MIN_TISSUE = 0.25


def _fixed_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.round((255 << HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.round((180 << HSV_SHIFT) / (6.0 * i)), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


_SDIV, _HDIV = _fixed_tables()


def rgb2hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2HSV) of a uint8 [..., 3] image: H in
    [0, 180), S and V in [0, 255], by OpenCV's integer arithmetic."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def rgb2gray_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2GRAY) of a uint8 [..., 3] image."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    cr, cg, cb = GRAY_RGB
    return ((r * cr + g * cg + b * cb + (1 << (GRAY_SHIFT - 1)))
            >> GRAY_SHIFT).astype(np.uint8)


def in_range(hsv: np.ndarray, lo: int = THRESH_LO, hi: int = THRESH_HI
             ) -> np.ndarray:
    """cv2.inRange with the same bounds on every channel: 255 / 0."""
    ok = ((hsv >= lo) & (hsv <= hi)).all(-1)
    return np.where(ok, 255, 0).astype(np.uint8)


def dilate(img: np.ndarray, k: int) -> np.ndarray:
    return ndimage.maximum_filter(img, size=k, mode="constant", cval=0)


def erode(img: np.ndarray, k: int) -> np.ndarray:
    return ndimage.minimum_filter(img, size=k, mode="constant", cval=255)


def close_open(thresh: np.ndarray) -> np.ndarray:
    """morphologyEx CLOSE (CLOSE_K square) then OPEN (OPEN_K square)."""
    closed = erode(dilate(thresh, CLOSE_K), CLOSE_K)
    return dilate(erode(closed, OPEN_K), OPEN_K)


# OpenCV's chain code directions: (dx, dy) of code k, counterclockwise on
# the screen from +x
_CODE = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
         (1, 1))


def trace_outer_border(fg: np.ndarray, x0: int, y0: int) -> np.ndarray:
    """The outer border of the 8-connected component whose first pixel in
    raster order is (x0, y0), by Suzuki's border following as OpenCV runs
    it: [K, 2] (x, y) border pixels in tracing order (only their polygon's
    area is used, which does not depend on where they are placed). `fg` is
    a bool image padded with a background frame (coordinates are in it)."""
    def at(x, y, k):
        dx, dy = _CODE[k & 7]
        return x + dx, y + dy

    # the first neighbour clockwise from the left (the background side)
    s = 4
    while True:
        s = (s - 1) & 7
        x1, y1 = at(x0, y0, s)
        if fg[y1, x1] or s == 4:
            break
    if not fg[y1, x1]:
        return np.asarray([(x0, y0)], np.int64)   # an isolated pixel
    pts = []
    x3, y3 = x0, y0
    while True:
        pts.append((x3, y3))
        # counterclockwise from the direction after the one we came from
        for _ in range(8):
            s += 1
            x4, y4 = at(x3, y3, s)
            if fg[y4, x4]:
                break
        s &= 7
        if (x4, y4) == (x0, y0) and (x3, y3) == (x1, y1):
            break
        x3, y3 = x4, y4
        s = (s + 4) & 7
    return np.asarray(pts, np.int64)


def contour_area(pts: np.ndarray) -> float:
    """cv2.contourArea: |shoelace| / 2 of the closed polygon."""
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))
                 / 2.0)


class Region(NamedTuple):
    box: Tuple[int, int, int, int]   # x, y, w, h (cv2.boundingRect)
    area: float                      # cv2.contourArea of the outline


_EIGHT = np.ones((3, 3), bool)
_FOUR = ndimage.generate_binary_structure(2, 1)


def external_regions(binary: np.ndarray):
    """(regions in cv2.findContours(RETR_EXTERNAL) order, the drawContours
    FILLED mask 255/0) of a binary image (nonzero = foreground)."""
    fg = np.pad(binary != 0, 1)
    # holes: background 4-components cut off from the outside frame
    bg_lab, _ = ndimage.label(~fg, structure=_FOUR)
    filled = bg_lab != bg_lab[0, 0]
    lab, n = ndimage.label(filled, structure=_EIGHT)
    regions = []
    for i, sl in enumerate(ndimage.find_objects(lab)):
        # the component's own pixels (its holes stay background, as in the
        # image OpenCV traces); nothing else is 8-adjacent to its outside
        comp = (lab[sl] == i + 1) & fg[sl]
        ys, xs = np.nonzero(comp[:1])           # the first row's pixels
        x0, y0 = sl[1].start + int(xs[0]), sl[0].start
        sub = np.pad(comp, 1)
        outline = trace_outer_border(sub, x0 - sl[1].start + 1, 1)
        box = (sl[1].start - 1, sl[0].start - 1, sl[1].stop - sl[1].start,
               sl[0].stop - sl[0].start)
        regions.append(((y0, x0), Region(box, contour_area(outline))))
    regions.sort(key=lambda r: r[0], reverse=True)
    mask = np.where(filled[1:-1, 1:-1], 255, 0).astype(np.uint8)
    return [r for _, r in regions], mask


class Extractor:
    """extract_patches() -> (patches [ps, ps, 3] uint8 views, (x, y)
    coords, tissue mask) of one slide at config's `level`."""

    def __init__(self, config: dict, wsi_path: str):
        self.cfg = config
        self.wsi_path = str(wsi_path)
        self.level = config.get("level", 0)
        self.patch_size = config.get("patch_size", 256)
        self.verbose = config.get("verbose", 0)

    def read_wsi(self) -> np.ndarray:
        """The whole level as RGBA; a level beyond the slide's raises."""
        try:
            from openslide import open_slide
        except ImportError:
            from PIL import Image

            img = Image.open(self.wsi_path).convert("RGBA")
            for _ in range(self.level):
                img = img.resize((max(1, img.size[0] // 2),
                                  max(1, img.size[1] // 2)))
            return np.asarray(img)
        wsi = open_slide(self.wsi_path)
        if self.level >= wsi.level_count:
            raise IndexError(f"config level {self.level} out of range: "
                             f"{self.wsi_path} has {wsi.level_count} "
                             f"level(s)")
        dims = wsi.level_dimensions[self.level]
        return np.asarray(wsi.read_region((0, 0), self.level, dims)
                          .convert("RGBA"))

    @staticmethod
    def construct_colored_wsi(rgba: np.ndarray):
        """(rgb, gray, hsv) of an RGBA image."""
        rgb = np.ascontiguousarray(rgba[..., :3])
        return rgb, rgb2gray_u8(rgb), rgb2hsv_u8(rgb)

    @staticmethod
    def segmentation_hsv(hsv: np.ndarray):
        """(regions, filled mask) of the thresholded, closed, opened HSV."""
        return external_regions(close_open(in_range(hsv)))

    def construct_bags(self, rgb: np.ndarray, regions: List[Region],
                       mask: np.ndarray):
        """The 5 largest regions' half-stride windows with >= 25% tissue."""
        patches, coords = [], []
        ps = self.patch_size
        largest = sorted(regions, key=lambda r: r.area, reverse=True)
        for region in largest[:N_REGIONS]:
            x, y, w, h = region.box
            for y0 in range(y, y + h, ps // 2):
                for x0 in range(x, x + w, ps // 2):
                    patch = rgb[y0:y0 + ps, x0:x0 + ps, :]
                    if patch.shape[:2] != (ps, ps):
                        continue
                    pm = mask[y0:y0 + ps, x0:x0 + ps] > 0
                    gray = rgb2gray_u8(np.where(pm[..., None], patch, 0))
                    if np.count_nonzero(gray) >= MIN_TISSUE * ps * ps:
                        patches.append(patch)
                        coords.append((int(x0), int(y0)))
        return patches, coords

    def extract_patches(self):
        t0 = time.time()
        rgb, _, hsv = self.construct_colored_wsi(self.read_wsi())
        regions, mask = self.segmentation_hsv(hsv)
        patches, coords = self.construct_bags(rgb, regions, mask)
        if self.verbose:
            print(f"extracted {len(patches)} patches in "
                  f"{time.time() - t0:.2f}s")
        return patches, coords, mask
