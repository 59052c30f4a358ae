"""The port's tissue extractor without OpenCV (wsi_hgnn_tpu_torch/pipeline/
extractor.py) against OpenCV and against the JAX package's Extractor, which
calls OpenCV.

Everything is exact: the uint8 HSV and grey conversions equal
cv2.cvtColor on every colour swept; the close/open morphology equals
cv2.morphologyEx; the external regions equal cv2.findContours
(RETR_EXTERNAL) in number, order, bounding box and contourArea, and the
filled mask equals cv2.drawContours(FILLED), on random blobs, noise,
nested rings and regions touching the border; the extractor's patches,
coordinates and mask equal the JAX Extractor's on seeded tissue images,
with regions touching the border and two regions of near-equal area."""
import cv2
import numpy as np
import pytest
from PIL import Image
from scipy import ndimage

from wsi_hgnn_tpu.pipeline.extractor import Extractor as JExtractor
from wsi_hgnn_tpu_torch.pipeline import extractor as tex
import port_threads  # noqa: F401  (torch threads per test worker)


@pytest.mark.parametrize("reds", [(0, 1, 19, 20, 21, 127), (199, 200, 201,
                                                             254, 255)])
def test_color_conversions_equal_cv2(reds):
    """Every (g, b) for each red value given, plus a million random
    colours."""
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rows = [np.stack([np.full_like(g, r), g, b], -1) for r in reds]
    rows.append(np.random.RandomState(reds[0]).randint(
        0, 256, (1024, 1024, 3)))
    for img in rows:
        img = img.astype(np.uint8)
        np.testing.assert_array_equal(tex.rgb2hsv_u8(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
        np.testing.assert_array_equal(tex.rgb2gray_u8(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
        lo, hi = np.array([20] * 3), np.array([200] * 3)
        hsv = tex.rgb2hsv_u8(img)
        np.testing.assert_array_equal(tex.in_range(hsv),
                                      cv2.inRange(hsv, lo, hi))


@pytest.mark.parametrize("seed", range(3))
def test_morphology_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(15):
        h, w = rng.randint(8, 90, 2)
        img = (rng.rand(h, w) < rng.uniform(0.2, 0.8)).astype(np.uint8) * 255
        want = cv2.morphologyEx(
            cv2.morphologyEx(img, cv2.MORPH_CLOSE, np.ones((15, 15), np.uint8)),
            cv2.MORPH_OPEN, np.ones((5, 5), np.uint8))
        np.testing.assert_array_equal(tex.close_open(img), want)


def assert_regions_equal_cv2(binary):
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    want_mask = np.zeros_like(binary)
    cv2.drawContours(want_mask, contours, -1, 255, thickness=cv2.FILLED)
    regions, mask = tex.external_regions(binary)
    assert [(cv2.boundingRect(c), cv2.contourArea(c)) for c in contours] \
        == [(r.box, r.area) for r in regions]
    np.testing.assert_array_equal(mask, want_mask)
    return regions


@pytest.mark.parametrize("kind", ["blobs", "noise"])
def test_external_regions_equal_find_contours(kind):
    rng = np.random.RandomState(7 if kind == "blobs" else 8)
    for _ in range(60):
        h, w = rng.randint(5, 70, 2)
        field = rng.rand(h, w)
        if kind == "blobs":
            field = ndimage.gaussian_filter(field, rng.uniform(0.5, 3.0))
            binary = field > rng.uniform(0.45, 0.55)
        else:
            binary = field < rng.uniform(0.2, 0.7)
        assert_regions_equal_cv2(binary.astype(np.uint8) * 255)


def test_nested_and_border_regions_equal_find_contours():
    img = np.zeros((60, 80), np.uint8)
    img[2:40, 2:40] = 255           # a ring ...
    img[6:36, 6:36] = 0
    img[12:20, 12:20] = 255         # ... with an island in its hole
    img[30:60, 70:80] = 255         # touching the bottom-right corner
    img[0:5, 50:60] = 255           # touching the top edge
    img[45, 10:30] = 255            # a one-pixel line
    img[50:53, 0:3] = 255           # touching the left edge
    img[44:47, 44:47] = 255         # diagonal neighbours: one component
    img[47:50, 47:50] = 255
    regions = assert_regions_equal_cv2(img)
    assert len(regions) == 6


def tissue_slide(path, seed, size=(1400, 1000), touch=True, twins=False):
    """A white slide with textured pink ellipses; optionally one running
    off the left and bottom edges, and two of near-equal area competing
    for the fifth place."""
    rng = np.random.RandomState(seed)
    w, h = size
    img = np.full((h, w, 3), 245, np.uint8)
    blob = np.zeros((h, w), np.uint8)
    ellipses = [((w // 2, h // 2), (260, 180)), ((220, 200), (120, 90)),
                ((1150, 780), (150, 110)), ((1180, 180), (50, 40))]
    if touch:
        ellipses += [((0, h - 1), (140, 160))]
    if twins:
        ellipses += [((420, 820), (71, 70)), ((800, 110), (70, 71)),
                     ((950, 560), (40, 40))]
    for centre, axes in ellipses:
        cv2.ellipse(blob, centre, axes, 0, 0, 360, 255, thickness=-1)
    noise = rng.randint(-30, 30, (h, w, 3))
    pink = np.clip(np.array([200, 120, 160]) + noise, 0, 255)
    img = np.where(blob[..., None] > 0, pink, img).astype(np.uint8)
    Image.fromarray(img).save(path)


@pytest.mark.parametrize("case", ["touching", "twins", "level1", "blank"])
def test_extractor_equals_jax(tmp_path, case):
    path = str(tmp_path / "slide.png")
    if case == "blank":
        Image.fromarray(np.full((600, 700, 3), 255, np.uint8)).save(path)
    else:
        tissue_slide(path, seed=len(case), twins=case == "twins")
    cfg = {"level": 1 if case == "level1" else 0, "patch_size": 128,
           "verbose": 0}
    got = tex.Extractor(cfg, path).extract_patches()
    want = JExtractor(cfg, path).extract_patches()
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], want[2])
    if case == "blank":
        assert got[1] == []
    else:
        assert len(got[1]) > 10
    if case == "twins":
        regions, _ = tex.external_regions(tex.close_open(tex.in_range(
            tex.rgb2hsv_u8(np.asarray(Image.open(path).convert("RGB"))))))
        areas = sorted((r.area for r in regions), reverse=True)
        assert len(areas) >= 7 and 0 < areas[4] - areas[5] < 0.02 * areas[4]
