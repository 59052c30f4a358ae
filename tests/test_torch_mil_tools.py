"""The port's MIL tools (wsi_hgnn_tpu_torch/tools/{pretrain_simclr,
vis_graphcam,process_remix_dataset}.py) against the JAX tools on the CPU,
and the checkpoints each writes read by the other.

  * pretrain_simclr, both modes: a best.pkl written by either package
    (tiny and KimiaNet backbones) loads in the other, and both extract
    modes then write the same bags: equal xy, features within 1e-5
    relative plus 1e-6 of the features' scale (KimiaNet: the port's fused
    f32 chain against the flax module, 1e-4 and 1e-4);
  * vis_graphcam: on a gtn fold pickle written by either package, the
    port's and JAX's `cam` within 2e-3 (the min-max normalised f32
    GraphCAM, whose safe_divide magnifies rounding) and `probs` within
    1e-5; the PNG is written;
  * process_remix_dataset: byte-equal lists, label arrays, labels.csv and
    bag files."""
import os
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

import train_mil as jtrain
from tools import pretrain_simclr as jsimclr
from tools import process_remix_dataset as jremix
from tools import vis_graphcam as jvis
from wsi_hgnn_tpu_torch import train_mil as ttrain
from wsi_hgnn_tpu_torch.tools import pretrain_simclr as tsimclr
from wsi_hgnn_tpu_torch.tools import process_remix_dataset as tremix
from wsi_hgnn_tpu_torch.tools import vis_graphcam as tvis
import port_threads  # noqa: F401  (torch threads per test worker)


def write_patch_slides(root, n_slides=4, per_slide=5, size=24, seed=0):
    """Per-slide directories of `{col}_{row}.jpeg` patches and labels."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_slides):
        d = root / f"s{i}"
        d.mkdir(parents=True)
        base = rng.randint(0, 200, (size, size, 3)) + (i % 2) * 55
        for j in range(per_slide):
            img = np.clip(base + rng.randint(-20, 20, (size, size, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"{j}_{i % 2}.jpeg")
        rows.append(f"s{i},{i % 2}")
    (root.parent / "labels.csv").write_text("\n".join(rows) + "\n")
    return str(root.parent / "labels.csv")


def read_bags(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with np.load(os.path.join(d, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def assert_same_bags(got, want, rtol, atol_frac=0.0):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name]["xy"], want[name]["xy"])
        w = want[name]["feat"]
        np.testing.assert_allclose(got[name]["feat"], w, rtol=rtol,
                                   atol=atol_frac * np.abs(w).max())


@pytest.mark.parametrize("backbone", ["tiny", "kimia"])
def test_pretrain_and_extract_cross_packages(tmp_path, backbone):
    patches = tmp_path / "patches"
    write_patch_slides(patches, n_slides=4 if backbone == "tiny" else 2)
    common = ["--patch-dir", str(patches), "--backbone", backbone,
              "--epochs", "2", "--batch", "4", "--image-size", "32",
              "--lr", "1e-3", "--warmup-epochs", "1", "--proj-dim", "16"]
    if backbone == "tiny":
        common.append("--train-backbone")
    port_ckpt = tsimclr.main(common + ["--out", str(tmp_path / "port"),
                                       "--device", "cpu"])
    with open(port_ckpt, "rb") as f:
        ck = pickle.load(f)
    assert {k: ck[k] for k in ("backbone", "proj_dim", "feat_dim",
                               "image_size")} == {
        "backbone": backbone, "proj_dim": 16,
        "feat_dim": 64 if backbone == "tiny" else 1024, "image_size": 32}
    assert (ck["batch_stats"] == {}) == (backbone == "tiny")
    ckpts = [port_ckpt]
    if backbone == "tiny":
        ckpts.append(jsimclr.main(common + ["--out", str(tmp_path / "jax")]))
    rtol, atol = (1e-5, 1e-6) if backbone == "tiny" else (1e-4, 1e-4)
    for k, ckpt in enumerate(ckpts):
        jsimclr.main(["--extract", "--ckpt", ckpt, "--patch-dir",
                      str(patches), "--out", str(tmp_path / f"jf{k}"),
                      "--batch", "3"])
        written = tsimclr.main(["--extract", "--ckpt", ckpt, "--patch-dir",
                                str(patches), "--out",
                                str(tmp_path / f"tf{k}"), "--batch", "3",
                                "--device", "cpu"])
        assert len(written) == len(os.listdir(patches))
        assert_same_bags(read_bags(tmp_path / f"tf{k}"),
                         read_bags(tmp_path / f"jf{k}"), rtol, atol)


def test_pretrain_refuses_a_small_corpus_and_extract_needs_ckpt(tmp_path):
    patches = tmp_path / "patches"
    write_patch_slides(patches, n_slides=1, per_slide=3)
    with pytest.raises(SystemExit, match="need >= 4"):
        tsimclr.main(["--patch-dir", str(patches), "--out", str(tmp_path),
                      "--batch", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--ckpt"):
        tsimclr.main(["--extract", "--patch-dir", str(patches), "--out",
                      str(tmp_path), "--device", "cpu"])


def write_bags(root, n_bags=6, d=16, seed=0):
    rng = np.random.RandomState(seed)
    rows = ["name,label"]
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_bags):
        n = int(rng.randint(20, 40))
        xy = np.stack([np.arange(n) % 9, np.arange(n) // 9], 1)
        np.savez(root / f"b{i}.npz",
                 feat=(rng.randn(n, d) + 0.7 * (i % 2)).astype(np.float32),
                 xy=xy)
        rows.append(f"b{i},{i % 2}")
    (root / "labels.csv").write_text("\n".join(rows) + "\n")
    return str(root / "labels.csv")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vis_graphcam_matches_jax(tmp_path, writer):
    bags = tmp_path / "bags"
    labels = write_bags(bags)
    flags = ["--model", "gtn", "--feats-dir", str(bags), "--labels", labels,
             "--folds", "2", "--epochs", "2", "--hidden", "16",
             "--clusters", "4", "--save-dir", str(tmp_path / "folds")]
    if writer == "jax":
        jtrain.main(flags)
    else:
        ttrain.main(flags + ["--device", "cpu"])
    pkl = str(tmp_path / "folds" / "gtn_fold0.pkl")
    bag = str(bags / "b3.npz")
    jvis.main(["--bag", bag, "--params", pkl, "--out", str(tmp_path / "j")])
    tvis.main(["--bag", bag, "--params", pkl, "--out", str(tmp_path / "t"),
               "--device", "cpu"])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        np.testing.assert_array_equal(t["xy"], j["xy"])
        np.testing.assert_allclose(t["probs"], j["probs"], rtol=1e-5,
                                   atol=1e-6)
        assert t["cam"].shape == j["cam"].shape and t["cam"].shape[0] == 2
        np.testing.assert_allclose(t["cam"], j["cam"], rtol=0, atol=2e-3)
    assert Image.open(tmp_path / "t.png").size[0] > 100
    ttrain.main(["--model", "abmil", "--feats-dir", str(bags), "--labels",
                 labels, "--folds", "2", "--epochs", "1", "--device", "cpu",
                 "--save-dir", str(tmp_path / "ab")])
    with pytest.raises(SystemExit, match="gtn"):
        tvis.main(["--bag", bag, "--params",
                   str(tmp_path / "ab" / "abmil_fold0.pkl"), "--device",
                   "cpu"])


def test_process_remix_dataset_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    gd = tmp_path / "graphs"
    gd.mkdir()
    rows = []
    for i in range(11):
        name = f"w{i}"
        n = rng.randint(6, 12)
        if i % 3:
            np.savez(gd / f"{name}.npz",
                     feat=rng.randn(n, 8).astype(np.float32))
        else:
            np.save(gd / f"{name}.npy", rng.randn(n, 8).astype(np.float32))
        if i != 10:
            rows.append(f"{name},{i % 3 % 2}")
    labels = tmp_path / "in_labels.csv"
    labels.write_text("\n".join(rows) + "\n")
    out = str(tmp_path / "ds")
    jremix.main(["--graph-dir", str(gd), "--labels", str(labels), "--out",
                 out, "--seed", "3"])
    shutil.move(out, str(tmp_path / "ds_jax"))
    tremix.main(["--graph-dir", str(gd), "--labels", str(labels), "--out",
                 out, "--seed", "3"])
    for dirpath, _, files in os.walk(tmp_path / "ds_jax"):
        rel = os.path.relpath(dirpath, tmp_path / "ds_jax")
        for name in files:
            want = open(os.path.join(dirpath, name), "rb").read()
            got = open(os.path.join(out, rel, name), "rb").read()
            assert got == want, os.path.join(rel, name)
    n_files = sum(len(f) for _, _, f in os.walk(out))
    assert n_files == sum(len(f) for _, _, f in os.walk(tmp_path / "ds_jax"))
    (tmp_path / "nobody.csv").write_text("name,label\n")
    with pytest.raises(SystemExit, match="no labelled graphs"):
        tremix.main(["--graph-dir", str(gd), "--labels",
                     str(tmp_path / "nobody.csv"), "--out", out])
