"""Port parity of the MIL k-fold script (wsi_hgnn_tpu_torch/train_mil.py)
against the root train_mil.py on the CPU: on a tiny cohort of `.npz` bags,
2 folds and 3 epochs without ReMix, from the init the JAX script draws,
the same fold metrics (abmil, dsmil, gtn, and h2mil at --dropout 0 on
synthetic trees); h2mil on real two-level nested bags featurized by the
'random' encoder: the same trees and fold metrics; the port's fold
pickles in JAX's tree; the CLI with ReMix and h2mil, --nested-bags
refused outside h2mil; the k-fold protocol and the LR schedule."""
import functools
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import train_mil as jtrain
from wsi_hgnn_tpu.models import mil as jmil
from wsi_hgnn_tpu_torch import train_mil as ttrain
import port_threads  # noqa: F401  (torch threads per test worker)

D, C = 16, 2


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def write_cohort(tmp_path, n_bags=8):
    """Separable bags of 12-30 instances as `.npz` (feat, and xy for half
    of them) and a labels CSV with one unlabelled bag the loader skips."""
    rng = np.random.RandomState(0)
    rows = ["name,label"]
    for i in range(n_bags + 1):
        n = int(rng.randint(12, 31))
        label = i % 2
        feats = (rng.randn(n, D) + 0.8 * label).astype(np.float32)
        extra = {}
        if i % 2:
            extra["xy"] = np.stack([rng.permutation(40)[:n],
                                    rng.randint(0, 3, n)], 1)
        np.savez(tmp_path / f"bag_{i:02d}.npz", feat=feats, **extra)
        if i < n_bags:
            rows.append(f"bag_{i:02d},{label}")
    (tmp_path / "labels.csv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "labels.csv")


@functools.lru_cache(maxsize=None)
def _jax_init(kind, in_dim, cap, seed, hidden=8, clusters=4):
    """The variables the JAX script's model.init draws for a fold."""
    if kind == "gtn":
        m = jmil.GraphTransformer(n_class=C, in_dim=in_dim, embed_dim=hidden,
                                  node_cluster_num=clusters)
        args = (jnp.zeros((1, cap, in_dim)), jnp.zeros((1, cap, cap)),
                jnp.ones((1, cap)))
    else:
        m = (jmil.ABMIL(num_classes=C) if kind == "abmil"
             else jmil.DSMIL(num_classes=C))
        args = (jnp.zeros((cap, in_dim)), jnp.ones((cap,), bool))
    return jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(seed), *args))


@pytest.mark.parametrize("kind", ["abmil", "dsmil", "gtn"])
def test_train_mil_fold_metrics_match_jax(tmp_path, kind):
    """Both scripts on one tiny cohort, 2 folds, 3 epochs, no ReMix, from
    the init JAX draws: the same fold metrics (summary), and the port's
    fold pickles hold JAX's tree."""
    labels = write_cohort(tmp_path)
    flags = ["--model", kind, "--feats-dir", str(tmp_path), "--labels",
             labels, "--folds", "2", "--epochs", "3", "--lr", "5e-3",
             "--hidden", "8", "--clusters", "4", "--seed", "3"]
    want = jtrain.main(flags + ["--save-dir", str(tmp_path / "jax")])
    args = ttrain.parser().parse_args(
        flags + ["--device", "cpu", "--save-dir", str(tmp_path / "port")])
    bags, ys, _, coords = ttrain.load_bags(str(tmp_path), labels)
    assert len(bags) == 8
    if kind == "gtn":
        from wsi_hgnn_tpu_torch.graph.typed_graph import bucket_size

        cap = bucket_size(max(len(b) for b in bags), base=64)
        got = ttrain.run_gtn(args, bags, ys, coords,
                             init_variables=_jax_init(kind, D, cap, 3))
    else:
        cap = max(max(len(b) for b in bags), 8)
        got = ttrain.run_bag_models(args, bags, ys,
                                    init_variables=_jax_init(kind, D, cap, 3))
    for key in want:
        if key != "model":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-9, err_msg=key)
    for fold in (0, 1):
        with open(tmp_path / "port" / f"{kind}_fold{fold}.pkl", "rb") as f:
            got_p = pickle.load(f)
        with open(tmp_path / "jax" / f"{kind}_fold{fold}.pkl", "rb") as f:
            want_p = pickle.load(f)
        assert got_p["meta"] == want_p["meta"]
        g, w = flat(got_p["params"]), flat(want_p["params"])
        assert {k: (v.shape, v.dtype) for k, v in g.items()} == \
            {k: (v.shape, v.dtype) for k, v in w.items()}


def test_train_mil_cli_runs_remix_and_refuses_h2mil(tmp_path, capsys):
    """ReMix and h2mil through the CLI; --nested-bags is refused for any
    model but h2mil."""
    labels = write_cohort(tmp_path)
    base = ["--feats-dir", str(tmp_path), "--labels", labels, "--folds", "2",
            "--epochs", "2", "--device", "cpu", "--num-prototypes", "3"]
    for mode in ("cov", "joint"):
        out = ttrain.main(["--model", "dsmil", "--remix-mode", mode] + base)
        assert np.isfinite([out["acc_mean"], out["auc_mean"]]).all()
    assert '"model": "dsmil"' in capsys.readouterr().out
    out = ttrain.main(["--model", "h2mil", "--hidden", "8", "--k1", "2",
                       "--k2", "4"] + base)
    assert np.isfinite([out["acc_mean"], out["auc_mean"]]).all()
    with pytest.raises(SystemExit, match="h2mil input mode"):
        ttrain.main(["--model", "gtn", "--nested-bags"] + base)


def _jax_h2mil_init(tree, hidden, k1, k2, seed):
    """The variables the JAX script's model.init draws (they depend on the
    feature width only, not on the tree's values)."""
    m = jmil.H2MIL(hidden_dim=hidden, n_classes=C, k1=k1, k2=k2, dropout=0.0)
    tree = jmil.TreeGraph(*(jnp.asarray(a) for a in tree))
    return jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(seed), tree))


def _assert_fold_pickles_match(tmp_path, kind):
    for fold in (0, 1):
        with open(tmp_path / "port" / f"{kind}_fold{fold}.pkl", "rb") as f:
            got_p = pickle.load(f)
        with open(tmp_path / "jax" / f"{kind}_fold{fold}.pkl", "rb") as f:
            want_p = pickle.load(f)
        assert got_p["meta"] == want_p["meta"]
        g, w = flat(got_p["params"]), flat(want_p["params"])
        assert {k: v.shape for k, v in g.items()} == \
            {k: v.shape for k, v in w.items()}


def test_h2mil_fold_metrics_match_jax(tmp_path):
    """Synthetic parent level (--cell 2), 2 folds x 3 epochs, dropout off,
    from JAX's init: the same fold metrics and fold pickles."""
    labels = write_cohort(tmp_path)
    flags = ["--model", "h2mil", "--feats-dir", str(tmp_path), "--labels",
             labels, "--folds", "2", "--epochs", "3", "--lr", "5e-3",
             "--hidden", "8", "--k1", "2", "--k2", "4", "--cell", "2",
             "--dropout", "0", "--seed", "1"]
    want = jtrain.main(flags + ["--save-dir", str(tmp_path / "jax")])
    args = ttrain.parser().parse_args(
        flags + ["--device", "cpu", "--save-dir", str(tmp_path / "port")])
    bags, ys, _, coords = ttrain.load_bags(str(tmp_path), labels)
    trees = ttrain.synthetic_trees(bags, coords, 2)
    got = ttrain.run_h2mil(args, bags, ys, coords, init_variables=
                           _jax_h2mil_init(trees[0], 8, 2, 4, 1))
    for key in want:
        if key != "model":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-9, err_msg=key)
    _assert_fold_pickles_match(tmp_path, "h2mil")


def write_nested_bags(root, n_slides=8, seed=0):
    """Two-magnification nested bags in the tiler's layout (class
    directories, low tiles with child directories of high tiles, a
    `-1.jpeg` thumbnail on half of the slides) and a labels CSV."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    rows = ["name,label"]
    for i in range(n_slides):
        label = i % 2
        bag = root / ("tumor" if label else "normal") / f"slide{i}"
        bag.mkdir(parents=True)
        cells = rng.permutation(12)[:int(rng.randint(4, 8))]
        for c in cells:
            x, y = int(c % 4), int(c // 4)
            img = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
            Image.fromarray(img).save(bag / f"{x}_{y}.jpeg")
            kids = [(2 * x + dx, 2 * y + dy) for dx in (0, 1)
                    for dy in (0, 1) if rng.rand() < 0.6]
            if kids:
                (bag / f"{x}_{y}").mkdir()
            for hx, hy in kids:
                img = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
                Image.fromarray(img).save(bag / f"{x}_{y}" / f"{hx}_{hy}.jpeg")
        if i % 2 == 0:
            Image.fromarray(rng.randint(0, 256, (16, 16, 3)).astype(
                np.uint8)).save(bag / "-1.jpeg")
        rows.append(f"slide{i},{label}")
    (root / "labels.csv").write_text("\n".join(rows) + "\n")
    return str(root / "labels.csv")


def test_nested_bags_match_jax(tmp_path):
    """--nested-bags --encoder random: both levels and the thumbnails
    featurized alike, the same TreeGraphs, and from JAX's init the same
    fold metrics and fold pickles."""
    labels = write_nested_bags(tmp_path / "tiles")
    want_t, want_y, want_n = jtrain.load_nested_trees(
        str(tmp_path / "tiles"), labels, "random")
    got_t, got_y, got_n = ttrain.load_nested_trees(
        str(tmp_path / "tiles"), labels, "random", device="cpu")
    assert got_n == want_n and np.array_equal(got_y, want_y)
    for g, w in zip(got_t, want_t):
        for name, a, b in zip(w._fields, g, w):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    flags = ["--model", "h2mil", "--nested-bags", "--encoder", "random",
             "--feats-dir", str(tmp_path / "tiles"), "--labels", labels,
             "--folds", "2", "--epochs", "2", "--lr", "5e-3", "--hidden",
             "8", "--k1", "2", "--k2", "4", "--dropout", "0"]
    want = jtrain.main(flags + ["--save-dir", str(tmp_path / "jax")])
    args = ttrain.parser().parse_args(
        flags + ["--device", "cpu", "--save-dir", str(tmp_path / "port")])
    got = ttrain.run_h2mil(args, None, None, None,
                           init_variables=_jax_h2mil_init(got_t[0], 8, 2, 4,
                                                          0))
    for key in want:
        if key != "model":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-9, err_msg=key)
    _assert_fold_pickles_match(tmp_path, "h2mil")
    out = ttrain.main(flags[:-2] + ["--device", "cpu"])
    assert np.isfinite(out["acc_mean"])


def test_kfold_protocol_and_schedule_match_jax():
    labels = np.asarray([0] * 10 + [1] * 6)
    for folds in (2, 5):
        for a, b in zip(ttrain.stratified_kfold_split(labels, folds),
                        jtrain.stratified_kfold_split(labels, folds)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    lr_of = jtrain.cosine_epoch_schedule(2e-4, 7, 3)
    t_of = ttrain.cosine_epoch_schedule(2e-4, 7)
    for c in range(30):
        np.testing.assert_allclose(t_of(c // 3), float(lr_of(c)), rtol=1e-6)
    assert os.path.basename(ttrain.__file__) == "train_mil.py"
