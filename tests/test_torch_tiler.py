"""Port parity of slide tiling (wsi_hgnn_tpu_torch/pipeline/tiler.py and
`python -m wsi_hgnn_tpu_torch.get_patches`) against the JAX package's
tiler and the root get_patches.py on the CPU: on a seeded ~1500x1100 RGB
slide image, at 1 and 2 magnifications, the same file tree with the same
bytes (the PIL backend; the port's workers are spawned, the JAX
package's forked), the out-of-range level skip, the nested bags, the PIL
DeepZoom addressing and the background filter.

The JAX tiler's runs happen in one subprocess that imports the JAX
package but starts no JAX computation: its workers fork, and forking a
test worker whose JAX thread pools are running can deadlock the child."""
import json
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from wsi_hgnn_tpu.pipeline import tiler as jtiler
from wsi_hgnn_tpu_torch import get_patches
from wsi_hgnn_tpu_torch.pipeline import tiler
import port_threads  # noqa: F401  (torch threads per test worker)

ROOT = Path(__file__).resolve().parent.parent
SLIDE = "TCGA-AA-0001-01Z-00-DX1"


def make_slide(path, w=1500, h=1100, seed=0):
    """White background with a textured elliptical 'tissue' region."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = (((yy - h / 2) / (h / 2.6)) ** 2 + ((xx - w / 2) / (w / 2.6)) ** 2
            < 1)
    noise = rng.randint(60, 220, (h, w, 3)).astype(np.uint8)
    img[blob] = noise[blob]
    Image.fromarray(img).save(path)


def tree(root: Path):
    """{relative path: bytes} of every file under root."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory):
    """data/FAKE/tumor/<slide>.png, the layout get_patches reads."""
    root = tmp_path_factory.mktemp("slides")
    d = root / "data" / "FAKE" / "tumor"
    d.mkdir(parents=True)
    make_slide(d / f"{SLIDE}.png")
    return root


def run_in(cwd: Path, fn):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return fn()
    finally:
        os.chdir(old)


def slide_path(slide_dir: Path) -> str:
    return str(slide_dir / "data" / "FAKE" / "tumor" / f"{SLIDE}.png")


def tile_kw(slide: str, levels, objective, workers):
    return dict(levels=levels, base_mag=40, objective=objective,
                workers=workers, background_t=10,
                class_index=len(slide.split(os.sep)) - 2)


GET_PATCHES_ARGS = ["-d", "FAKE", "-v", "png", "-b", "40", "-o", "40", "-t",
                    "10", "-j", "2"]
# (name, magnifications) of the get_patches runs
MAGS = (("one", ["0"]), ("two", ["0", "1"]))

_JAX_RUNS = """
import json, os, runpy, sys
from wsi_hgnn_tpu.pipeline import tiler
root, slide, kws, args, mags = json.loads(sys.argv[1])
for name, kw in kws.items():
    os.makedirs(os.path.join(root, name))
    os.chdir(os.path.join(root, name))
    tiler.tile_slides([slide], "bags", **kw)
for name, m in mags:
    os.chdir(os.path.join(root, "get_patches_" + name))
    sys.argv = ["get_patches.py", *args, "-m", *m]
    runpy.run_path(os.path.join({repo!r}, "get_patches.py"),
                   run_name="__main__")
"""


def copy_slide_data(slide_dir: Path, cwd: Path) -> None:
    """A working directory holding data/FAKE/tumor/<slide>.png."""
    src = Path(slide_path(slide_dir))
    (cwd / "data" / "FAKE" / "tumor").mkdir(parents=True)
    (cwd / "data" / "FAKE" / "tumor" / src.name).write_bytes(src.read_bytes())


@pytest.fixture(scope="module")
def jax_runs(slide_dir, tmp_path_factory):
    """The JAX tiler's outputs, made in one subprocess: tile_slides at 1
    and 2 magnifications and at an out-of-range level ('level0',
    'level01', 'out_of_range'), and the root get_patches.py with 1 and 2
    magnifications ('get_patches_one', 'get_patches_two'). Returns
    (root, the subprocess's stderr)."""
    root = tmp_path_factory.mktemp("jax_tiles")
    slide = slide_path(slide_dir)
    kws = {"level0": tile_kw(slide, (0,), 40, 2),
           "level01": tile_kw(slide, (0, 1), 40, 2),
           "out_of_range": tile_kw(slide, (0,), 20, 1)}
    for name, _ in MAGS:
        copy_slide_data(slide_dir, root / f"get_patches_{name}")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_RUNS.format(repo=str(ROOT)),
         json.dumps([str(root), slide, kws, GET_PATCHES_ARGS, MAGS])],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return root, out.stderr


@pytest.mark.parametrize("levels", [(0,), (0, 1)])
def test_tile_slides_writes_the_jax_tiles(slide_dir, jax_runs, tmp_path,
                                          levels):
    """tile_slides at 1 magnification (flat bags) and 2 (each low-mag tile
    with a folder of its high-mag tiles, the childless ones kept) writes
    the JAX tile_slides' tree, byte for byte, and removes its temporary
    DeepZoom tree."""
    slide = slide_path(slide_dir)
    run_in(tmp_path, lambda: tiler.tile_slides(
        [slide], "bags", **tile_kw(slide, levels, 40, 2)))
    got = tree(tmp_path)
    name = "level0" if levels == (0,) else "level01"
    assert got == tree(jax_runs[0] / name)
    tiles = [k for k in got if k.endswith(".jpeg")]
    assert all(k.startswith(f"bags/tumor/{SLIDE}/") for k in tiles)
    # 6x5 tiles at full resolution, the white corners rejected
    if levels == (0,):
        assert 10 <= len(tiles) < 30
    else:
        low = [k for k in tiles if k.count("/") == 3]
        high = [k for k in tiles if k.count("/") == 4]
        assert low and high and len(high) <= 4 * len(low)
    assert not any("WSI_temp" in k for k in got)


def test_out_of_range_level_is_skipped(slide_dir, jax_runs, tmp_path, capfd):
    """Objective 20 against base 40 asks for a level above the image's
    full resolution: both tilers skip it with a message and write no
    tile, where indexing it would crash or tile the wrong level."""
    slide = slide_path(slide_dir)
    run_in(tmp_path, lambda: tiler.tile_slides(
        [slide], "o", **tile_kw(slide, (0,), 20, 1)))
    assert not list(tmp_path.rglob("*.jpeg"))
    assert not list((jax_runs[0] / "out_of_range").rglob("*.jpeg"))
    for err in (capfd.readouterr().err, jax_runs[1]):
        assert "skipping magnification 40: DeepZoom level" in err


@pytest.mark.parametrize("name,mags", MAGS)
def test_get_patches_entry_point_matches_the_root_script(
        slide_dir, jax_runs, tmp_path, monkeypatch, name, mags):
    """`python -m wsi_hgnn_tpu_torch.get_patches` with the root script's
    flags writes its tree: data/patches/<ds>/patches_lv0_ps256 at one
    magnification, WSI/<ds>/pyramid at two."""
    copy_slide_data(slide_dir, tmp_path)
    monkeypatch.chdir(tmp_path)
    out_base = get_patches.main([*GET_PATCHES_ARGS, "-m", *mags])
    got, want = (
        {k: v for k, v in tree(cwd).items() if not k.startswith("data/FAKE")}
        for cwd in (tmp_path, jax_runs[0] / f"get_patches_{name}"))
    prefix = ("WSI/FAKE/pyramid" if len(mags) == 2
              else "data/patches/FAKE/patches_lv0_ps256")
    assert out_base == os.path.join(*prefix.split("/"))
    assert got == want and got
    assert all(k.startswith(f"{prefix}/tumor/{SLIDE}/") for k in got)


def test_workers_are_spawned_and_stopped(slide_dir, tmp_path):
    """The tiler starts its workers with spawn (safe in a threaded parent)
    and every one has exited when `run` returns."""
    assert issubclass(tiler.TileWorker,
                      multiprocessing.get_context("spawn").Process)
    slide = slide_path(slide_dir)
    t = run_in(tmp_path, lambda: tiler.DeepZoomStaticTiler(
        slide, "tmp", (0,), 40, 40, "jpeg", 256, 0, True, 70, 2, 10))
    run_in(tmp_path, t.run)
    assert all(not w.is_alive() and w.exitcode == 0 for w in t._workers)
    assert len(list((tmp_path / "tmp_files").rglob("*.jpeg"))) > 0


def test_pil_deepzoom_and_background_filter_match_jax(tmp_path):
    """Level and tile addressing, clipped edge tiles, overlap on inner
    sides only, and the FIND_EDGES filter, as the JAX package's."""
    p = tmp_path / "s.png"
    make_slide(p, 600, 400)
    img = Image.open(p)
    for ov in (0, 2):
        a, b = tiler.PilDeepZoom(img, 256, ov), jtiler.PilDeepZoom(img, 256, ov)
        assert (a.level_count, a.level_dimensions, a.level_tiles,
                a.tile_count) == (b.level_count, b.level_dimensions,
                                  b.level_tiles, b.tile_count)
        for lv in (a.level_count - 1, a.level_count - 2):
            for addr in ((0, 0), (1, 1), (2, 1)):
                if addr[0] < a.level_tiles[lv][0] and \
                        addr[1] < a.level_tiles[lv][1]:
                    ta, tb = a.get_tile(lv, addr), b.get_tile(lv, addr)
                    assert ta.size == tb.size
                    assert ta.tobytes() == tb.tobytes()
    assert tiler.PilDeepZoom(img, 256).get_tile(
        tiler.PilDeepZoom(img, 256).level_count - 1, (2, 1)).size == (88, 144)
    white = Image.new("RGB", (256, 256), (255, 255, 255))
    noisy = Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (256, 256, 3), dtype=np.uint8))
    for t in (white, noisy):
        for thr in (5, 15):
            assert tiler.tile_is_foreground(t, 256, thr) == \
                jtiler.tile_is_foreground(t, 256, thr)
    assert not tiler.tile_is_foreground(white, 256, 15)
    assert tiler.tile_is_foreground(noisy, 256, 15)


def test_nested_patches_matches_jax(tmp_path):
    """2-level bags from a hand-made temp tree: a low-mag tile with one
    high-mag child, one whose children are all gone (kept, no folder)."""
    outs = {}
    for name, mod in (("jax", jtiler), ("port", tiler)):
        cwd = tmp_path / name
        for rel in ("t_files/10/0_0.jpeg", "t_files/10/1_0.jpeg",
                    "t_files/20/1_1.jpeg", "t_files/20/5_5.jpeg"):
            (cwd / rel).parent.mkdir(parents=True, exist_ok=True)
            (cwd / rel).write_bytes(rel.encode())
        bag = run_in(cwd, lambda: mod.nested_patches(
            os.path.join("d", "c", "s.png"), "out", "t", (0, 1), "jpeg", 1))
        assert bag == os.path.join("out", "c", "s")
        outs[name] = tree(cwd / "out")
    assert outs["port"] == outs["jax"] == {
        "c/s/0_0.jpeg": b"t_files/10/0_0.jpeg",
        "c/s/0_0/1_1.jpeg": b"t_files/20/1_1.jpeg",
        "c/s/1_0.jpeg": b"t_files/10/1_0.jpeg"}
