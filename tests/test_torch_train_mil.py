"""Port parity of the MIL k-fold script (wsi_hgnn_tpu_torch/train_mil.py)
against the root train_mil.py on the CPU: on a tiny cohort of `.npz` bags,
2 folds and 3 epochs without ReMix, from the init the JAX script draws,
the same fold metrics; the port's fold pickles in JAX's tree; the CLI
with ReMix; h2mil refused; the k-fold protocol and the LR schedule."""
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
    labels = write_cohort(tmp_path)
    base = ["--feats-dir", str(tmp_path), "--labels", labels, "--folds", "2",
            "--epochs", "2", "--device", "cpu", "--num-prototypes", "3"]
    for mode in ("cov", "joint"):
        out = ttrain.main(["--model", "dsmil", "--remix-mode", mode] + base)
        assert np.isfinite([out["acc_mean"], out["auc_mean"]]).all()
    assert '"model": "dsmil"' in capsys.readouterr().out
    for extra in (["--model", "h2mil"], ["--model", "gtn", "--nested-bags"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ttrain.main(extra + base)


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
