"""Port parity of graph construction (wsi_hgnn_tpu_torch/pipeline/,
get_graph.py, data/datasets.py::WSIData, models/featurizers/convert.py
and the encoders' weight loading) against the JAX package on the CPU:
the three outputs per slide (indices exact, sim 1e-5, node types equal),
the patch stream's two routes, the splits, the reference-checkpoint key
maps (array for array) and the kimia encoder built from such files."""
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import wsi_hgnn_tpu.models.featurizers as jfeat
from wsi_hgnn_tpu.models.featurizers import convert as jconvert
from wsi_hgnn_tpu.models.featurizers.densenet import KimiaNet as JaxKimiaNet
from wsi_hgnn_tpu.models.featurizers.hovernet import HoVerNet as JaxHoVerNet
from wsi_hgnn_tpu.models.featurizers.hovernet import hovernet_typing_apply
from wsi_hgnn_tpu.pipeline import construct as jconstruct
from wsi_hgnn_tpu.pipeline import patches as jpatches
from wsi_hgnn_tpu.pipeline import splits as jsplits
from wsi_hgnn_tpu_torch import get_graph
from wsi_hgnn_tpu_torch.data import WSIData
from wsi_hgnn_tpu_torch.models.featurizers import (HoVerNet, KimiaNet,
                                                   convert, make_cnn_encoder)
from wsi_hgnn_tpu_torch.models.featurizers import _seeded, load_cnn_variables
from wsi_hgnn_tpu_torch.pipeline import construct, patches, splits
from wsi_hgnn_tpu_torch.profiling import StageTimer

from test_torch_zoo import flat
import port_threads  # noqa: F401  (torch threads per test worker)

SIZES = {"TCGA-AA-0001-01Z-00-DX1": 12, "TCGA-AA-0002-11A-00-DX1": 3,
         "TCGA-AA-0003-01Z-00-DX1": 40}


def write_slides(root: Path, sizes=SIZES, wh=(40, 30), seed=0):
    """Seeded PNG patches in the patch_path/<class>/<slide>/ layout;
    non-square, so every patch goes through the resize and centre crop."""
    rng = np.random.RandomState(seed)
    for slide, n in sizes.items():
        d = root / "patches" / "tumor" / slide
        d.mkdir(parents=True)
        for i in range(n):
            px = rng.randint(0, 256, (wh[1], wh[0], 3)).astype(np.uint8)
            Image.fromarray(px).save(d / f"{i:03d}_0.png")
    return str(root / "patches") + "/"


def graph_config(root: Path, patch_path: str, **kw):
    cfg = {"dataset": "BRCA", "task": "cancer classification",
           "patch_path": patch_path, "out_dir": str(root / "graphs"),
           "node_type_dir": None, "encoder_name": "random",
           "feature_dim": 64, "radius": 5, "n_node_type": 6,
           "knn_impl": "exact"}
    cfg.update(kw)
    return cfg


def test_construct_all_writes_what_the_jax_package_writes(tmp_path):
    """construct_all with the random encoder on three PNG slides (one
    smaller than k) writes the JAX package's three outputs per slide:
    src/dst and the node types exactly, sim to 1e-5, the rest equal; the
    'pallas' KNN route writes the same files as 'exact'."""
    patch_path = write_slides(tmp_path)
    outs = {}
    for name, mod, kw in (("jax", jconstruct, {}),
                          ("port", construct, {"device": "cpu"}),
                          ("pallas", construct, {"device": "cpu"})):
        cfg = graph_config(tmp_path / name, patch_path,
                           knn_impl="pallas" if name == "pallas" else "exact")
        enc = mod.random_encoder(64)
        assert mod.construct_all(cfg, {"batch_size": 5}, {}, encoder=enc,
                                 verbose=False, **kw) == 3
        outs[name] = Path(cfg["out_dir"])
    for slide in SIZES:
        for kind in ("heterogeneous", "homogeneous"):
            files = {k: np.load(v / kind / f"{slide}.npz")
                     for k, v in outs.items()}
            want = files["jax"]
            for got in (files["port"], files["pallas"]):
                assert sorted(got.files) == sorted(want.files)
                for key in want.files:
                    if key == "sim":
                        np.testing.assert_allclose(got[key], want[key],
                                                   rtol=1e-5, atol=1e-5)
                    else:
                        np.testing.assert_array_equal(got[key], want[key],
                                                      err_msg=key)
        types = [np.load(v / "node_types" / f"{slide}.npy")
                 for v in outs.values()]
        for t in types[1:]:
            np.testing.assert_array_equal(t, types[0])
        assert types[0].dtype == np.int32 and len(types[0]) == SIZES[slide]


def test_construct_all_skips_existing_and_failed_slides(tmp_path, capsys):
    """A slide whose outputs exist is skipped; a slide that fails with one
    of the loop's caught errors (here: no patches) is skipped with a
    message, the reference's robustness by skip; a corrupt patch file
    raises out of the loop, in both packages."""
    patch_path = write_slides(tmp_path, {"s1": 4, "s3": 2})
    (Path(patch_path) / "tumor" / "s2").mkdir()
    cfg = graph_config(tmp_path, patch_path)
    enc = construct.random_encoder(64)
    assert construct.construct_all(cfg, {}, {}, encoder=enc,
                                   device="cpu") == 2
    assert "Failed to construct graph (no patches" in capsys.readouterr().out
    assert construct.construct_all(cfg, {}, {}, encoder=enc,
                                   device="cpu") == 0
    (Path(patch_path) / "tumor" / "s2" / "zz.png").write_bytes(b"not a png")
    for mod, kw in ((construct, {"device": "cpu"}), (jconstruct, {})):
        with pytest.raises(OSError, match="cannot identify image"):
            mod.construct_all(cfg, {}, {}, encoder=enc, verbose=False, **kw)


def test_patch_stream_routes_yield_identical_batches(tmp_path):
    """The prefetch thread and the decode pool yield the same batches as
    the JAX package's loader (resize to 256 BILINEAR, centre crop),
    trailing batch included, uint8 and f32; decode seconds are booked on
    both routes; a corrupt patch raises in the consumer on both."""
    write_slides(tmp_path, {"s": 7}, wh=(300, 260))
    paths = patches.list_patches(tmp_path / "patches" / "tumor" / "s")
    assert paths == jpatches.list_patches(tmp_path / "patches" / "tumor" / "s")
    timer = StageTimer()
    seq = list(patches.iter_patch_batches(paths, 3, timer=timer,
                                          timer_stage="decode"))
    pooled = list(patches.iter_patch_batches(paths, 3, decode_workers=2,
                                             timer=timer,
                                             timer_stage="decode"))
    want = list(jpatches.iter_patch_batches(paths, 3))
    assert [b.shape for b in seq] == [(3, 256, 256, 3)] * 2 + [(1, 256, 256, 3)]
    for a, b, c in zip(seq, pooled, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert timer.counts["decode"] == 6 and timer.totals["decode"] > 0
    u8 = list(patches.iter_patch_batches(paths, 3, decode_workers=2,
                                         out_dtype="uint8"))
    for a, b in zip(seq, u8):
        assert b.dtype == np.uint8
        np.testing.assert_array_equal(a, b.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(patches.load_patch(paths[0]),
                                  jpatches.load_patch(paths[0]))

    (paths[0].parent / "zz_corrupt.png").write_bytes(b"not a png")
    paths = patches.list_patches(paths[0].parent)
    for kw in ({}, {"prefetch": 0}, {"decode_workers": 2}):
        with pytest.raises(Exception):
            list(patches.iter_patch_batches(paths, 2, **kw))


def _split_files(out_dir):
    return {p.relative_to(out_dir).as_posix(): p.read_text()
            for p in sorted(Path(out_dir).glob("list_*/*.txt"))}


@pytest.mark.parametrize("task,dataset", [
    ("cancer classification", "BRCA"), ("cancer staging", "BRCA"),
    ("cancer staging", "COAD"), ("cancer typing", "BRCA"),
    ("cancer typing", "ESCA"), ("x", "camelyon16")])
def test_splits_match_jax(tmp_path, task, dataset):
    """generate_splits writes the JAX package's list files for every task,
    under a graphs directory whose path holds 'TCGA' (the barcode is read
    from the file name) and with a 'Stage IB' case (kept for BRCA,
    dropped for COAD)."""
    out = tmp_path / "TCGA_BRCA" / "graphs"
    for kind in ("homogeneous", "heterogeneous"):
        (out / kind).mkdir(parents=True)
    stages = ["Stage IB", "Stage IA", "Stage II", "Stage IIIC", "Stage IV"]
    labels, normals = [], []
    names = [f"{p}{i}" for p in ("tumor_", "normal_", "test_")
             for i in range(3)] if dataset == "camelyon16" else []
    for i in range(20):
        case = f"TCGA-A{i % 3}-{i:04d}"
        names.append(f"{case}-{'11A' if i % 4 == 0 else '01Z'}-00-DX1")
        if i % 4 == 0:
            normals.append(names[-1][:16])
        if task == "cancer staging":
            labels.append(f"{case}\t{stages[i % 5]}")
        elif dataset == "ESCA":
            labels.append(f"{case},{i % 3}")
        else:
            labels.append(f"{case}\tInfiltrating "
                          f"{'Ductal' if i % 2 else 'Lobular'} Carcinoma")
    for name in names:
        for kind in ("homogeneous", "heterogeneous"):
            (out / kind / f"{name}.npz").write_bytes(b"x")
    (tmp_path / "normal.txt").write_text("\n".join(normals) + "\n")
    (tmp_path / "labels.txt").write_text("\n".join(labels) + "\n")
    cfg = {"out_dir": str(out), "dataset": dataset, "task": task}
    kw = dict(fold=2, seed=3, normal_path=str(tmp_path / "normal.txt"),
              label_path=str(tmp_path / "labels.txt"))
    jsplits.generate_splits(cfg, **kw)
    want = _split_files(out)
    for p in out.glob("list_*"):
        for f in p.iterdir():
            f.unlink()
        p.rmdir()
    splits.generate_splits(cfg, **kw)
    got = _split_files(out)
    assert got == want and len(got) == 6
    listed = sum(len(t.split()) for k, t in got.items()
                 if k.split("/")[1].startswith("homogeneous"))
    assert listed > 0
    if task == "cancer staging":  # case 5 is at stage IB
        assert ("TCGA-A2-0005" in "".join(got.values())) == (dataset == "BRCA")


def test_wsidata_lists_slides_recursively(tmp_path):
    for rel in ("a/x.svs", "a/b/y.tif", "c/z.svs", "c/n.png"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    from wsi_hgnn_tpu.data.datasets import WSIData as JaxWSIData

    assert sorted(WSIData(tmp_path)) == sorted(JaxWSIData(tmp_path)) == \
        sorted(str(tmp_path / r) for r in ("a/x.svs", "a/b/y.tif", "c/z.svs"))
    assert len(WSIData(tmp_path)) == 3


# --------------------------------------------------------------------- #
# reference checkpoints
# --------------------------------------------------------------------- #
def _perturbed(variables, seed):
    """Seeded BatchNorm statistics and biases away from 1/0, so every leaf
    of a checkpoint carries information."""
    rng = np.random.RandomState(seed)
    out = {}
    for coll, tree in variables.items():
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + [k]) for k, v in node.items()}
            a = np.asarray(node, np.float32)
            leaf = path[-1]
            if leaf in ("bias", "mean"):
                return (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
            if leaf in ("scale", "var"):
                return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
            return a
        out[coll] = walk(tree, [])
    return out


def hovernet_variables(seed):
    """A seeded flax tree of the reference HoVer-Net (all three decoder
    branches, no fc1): the port's seeded init of that net, BatchNorm
    perturbed."""
    return _perturbed(_seeded(HoVerNet(6, "fast", with_fc1=False), seed),
                      seed)


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """A KimiaNet weights file and a HoVer-Net tar under the reference's
    key names, written by the port's inverse maps (the tar's 'desc' dict
    with an fc1 entry, as the reference's own net saves), and the flax
    trees they were written from."""
    root = tmp_path_factory.mktemp("weights")
    kimia = _perturbed(_seeded(KimiaNet(), 5), 5)
    hover = hovernet_variables(6)
    kpath, hpath = root / "KimiaNet.pth", root / "hovernet.tar"
    # the reference's KimiaNet file is read by position, so its names
    # (here DataParallel's) do not matter
    torch.save({f"module.{k}": torch.from_numpy(v)
                for k, v in convert.kimianet_state_dict(kimia).items()}, kpath)
    hsd = {k: torch.from_numpy(v)
           for k, v in convert.hovernet_state_dict(hover).items()}
    hsd["fc1.weight"] = torch.zeros(4, 8)
    hsd["fc1.bias"] = torch.zeros(4)
    torch.save({"desc": hsd, "epoch": 3}, hpath)
    return str(kpath), str(hpath), kimia, hover


def test_reference_key_maps_match_jax(weight_files):
    """load_kimianet and hovernet_torch_to_flax give the JAX converters'
    trees array for array, and they are the trees the files were written
    from (every leaf covered, so the inverse maps are exact);
    load_torch_state_dict reads with weights_only and unwraps 'desc'."""
    kpath, hpath, kimia, hover = weight_files
    got, want = (flat(convert.load_kimianet(kpath)),
                 flat(jconvert.load_kimianet(kpath)))
    kimia = flat(kimia)
    assert got.keys() == want.keys() == kimia.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(kimia[k], v, err_msg=k)

    sd = convert.load_torch_state_dict(hpath)
    jsd = jconvert.load_torch_state_dict(hpath)
    assert sd.keys() == jsd.keys() and "fc1.weight" in sd
    sd = {k: v for k, v in sd.items() if not k.startswith("fc1.")}
    got = flat(convert.hovernet_torch_to_flax(sd, 6))
    want = flat(jconvert.hovernet_torch_to_flax(sd, 6))
    hover = flat(hover)
    assert got.keys() == want.keys() == hover.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(hover[k], v, err_msg=k)
    assert jconvert.strip_dataparallel({"module.a.b": 1}) == \
        convert.strip_dataparallel({"module.a.b": 1}) == {"a.b": 1}


def test_kimia_encoder_from_reference_files_matches_jax(weight_files,
                                                        capsys):
    """The port's kimia encoder with inline typing, built from the two
    files (paths in the configs, as every GraphConstruction config sets
    them), equals the JAX encoder built from the same files on a patch:
    features to rtol 1e-4 / atol 1e-6 in f32, node types equal. One line
    per CNN names the file that ran.

    The JAX encoder is assembled from the JAX package's own parts, as its
    make_cnn_encoder assembles them off the TPU: the converters read the
    files (which hold every leaf, test_reference_key_maps_match_jax),
    `_make_encode` pads and scales the chunk, and the flax KimiaNet and
    hovernet_typing_apply run in one program, jitted with the weights as
    arguments (closing over them would embed them as constants, which
    takes XLA longer to compile than the forward takes to run)."""
    kpath, hpath, _, _ = weight_files
    hcfg = {"hovernet_model_path": hpath, "mode": "fast", "batch_size": 1}
    kcfg = {"kimianet_model_path": kpath}
    cfg = {"feature_dim": 1024, "n_node_type": 6}
    px = np.random.RandomState(0).randint(0, 256, (1, 256, 256, 3)
                                          ).astype(np.uint8)
    enc = make_cnn_encoder("kimia", cfg, hcfg, kcfg, with_typing=True,
                           pad_batch_to=1, device="cpu")
    out = capsys.readouterr().out
    assert f"kimia weights: {kpath}" in out and f"hover weights: {hpath}" in out
    f_t, t_t = enc(px)

    kimia = jconvert.load_kimianet(kpath)
    hover = jconvert.hovernet_torch_to_flax(
        {k: v for k, v in jconvert.load_torch_state_dict(hpath).items()
         if not k.startswith("fc1.")}, 6)
    jkimia = JaxKimiaNet()
    jhover = JaxHoVerNet(nr_types=6, mode="fast", with_fc1=False)

    @jax.jit
    def both(kv, hv, imgs):
        return (jkimia.apply(kv, imgs, train=False)[0],
                hovernet_typing_apply(jhover, hv, imgs))

    jenc = jfeat._make_encode(
        lambda a: both(kimia, hover, jfeat._norm_pixels(a)), 1, 1)
    f_j, t_j = jenc(px)
    assert f_t.shape == (1, 1024)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(t_t, np.asarray(t_j))


def test_missing_weight_files_give_the_seeded_init(tmp_path, capsys):
    """Weights paths that do not exist give the seeded init, as the JAX
    package falls back to its init: the same variables as no path at all,
    and a line that says so, for both CNNs."""
    gone = str(tmp_path / "absent.pth")
    for kind, module, seed in (("kimia", KimiaNet(), 1),
                               ("hover", HoVerNet.typing(6, "fast"), 0)):
        got = flat(load_cnn_variables(kind, module, gone, seed))
        want = flat(load_cnn_variables(kind, module, None, seed))
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        log = capsys.readouterr().out
        assert f"{kind} weights: seeded init (seed {seed}), {gone} not found" \
            in log
        assert f"{kind} weights: seeded init (seed {seed}), no weights path " \
            "set" in log


def test_get_graph_entry_point(tmp_path, monkeypatch):
    """`python -m wsi_hgnn_tpu_torch.get_graph` constructs on the card by
    default and raises without one; with `-device cpu` it constructs the
    slides and writes the splits (--yes skips the prompt); an encoder
    neither package builds ('efficientnet-b7') raises before any slide is
    skipped."""
    patch_path = write_slides(tmp_path)
    cfg_text = "graph_constructor:\n" + "".join(
        f"  {k}: {'' if v is None else v}\n"
        for k, v in graph_config(tmp_path, patch_path).items()
        if k != "task") + "hovernet_config:\n  batch_size: 8\n"
    (tmp_path / "g.yml").write_text(cfg_text)
    normal = tmp_path / "normal.txt"
    normal.write_text("TCGA-AA-0002-11A\n")
    argv = ["-config", str(tmp_path / "g.yml"), "--construct"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_graph.main(argv)
    get_graph.main(argv + ["--trainval", "--yes", "--normal-path",
                           str(normal), "-device", "cpu"])
    out = tmp_path / "graphs"
    assert len(list((out / "homogeneous").glob("*.npz"))) == 3
    assert len(list((out / "node_types").glob("*.npy"))) == 3
    assert len(list((out / "list_f1").glob("*.txt"))) == 6
    (tmp_path / "h.yml").write_text(cfg_text.replace("random",
                                                     "efficientnet-b7"))
    with pytest.raises(NotImplementedError, match="efficientnet-b7"):
        get_graph.main(["-config", str(tmp_path / "h.yml"), "--construct",
                        "-device", "cpu"])
