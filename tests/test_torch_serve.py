"""Port parity for the slice as a whole: pixels in, probabilities out.

The JAX `SlidePredictor` (checkpoint written by its CheckpointManager)
and the port's `SlidePredictor` serve the same uint8 256x256 patches on
the same weights: KimiaNet features + HoVer-Net typing, KNN + Pearson
lattice, HEAT4 with per-slide presence, softmax. Plus the port's device
contract: no silent CPU fall-back, and chip_smoke.py refuses to run
without a card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from wsi_hgnn_tpu.config import parse_lattice_twin as jax_twin
from wsi_hgnn_tpu.models.lattice import build_lattice_device as jax_build
from wsi_hgnn_tpu.serve import SlidePredictor as JaxPredictor
from wsi_hgnn_tpu.train.checkpoint import CheckpointManager
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.utils import resolve_device
import port_threads  # noqa: F401  (torch threads per test worker)

ROOT = Path(__file__).resolve().parent.parent
RADIUS = 4
CHUNK = 4
GNN = {"name": "HEAT4", "n_node_types": 6, "num_layers": 2, "in_dim": 1024,
       "hidden_dim": 32, "out_dim": 2, "n_heads": 2, "num_heads": 2,
       "feat_drop": 0.0, "graph_pooling_type": "mean"}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both predictors on one set of weights, and two slides of 3 and 5
    uint8 patches (a slide smaller than k, and one chunk plus a ragged
    chunk), served by each."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfg = {"name": "SliceTest", "GNN": dict(GNN),
           "checkpoint": {"path": str(ckpt)}}
    rng = np.random.RandomState(0)
    g0 = jax_build(jnp.asarray(rng.randn(1, 64, 1024).astype(np.float32)),
                   jnp.asarray(rng.randint(0, 6, (1, 64)).astype(np.int32)),
                   jnp.ones((1, 64), bool), RADIUS, 6)
    variables = jax_twin(cfg["GNN"]).init(jax.random.PRNGKey(0), g0)
    CheckpointManager(str(ckpt)).write_new_version(
        cfg, {"params": variables["params"], "batch_stats": {}}, {"Epoch": 1})

    # the JAX encoder initialises its CNNs itself (make_cnn_encoder); record
    # those weights for the port, and jit the inits, which are otherwise
    # run op by op (the values are the same)
    captured = {}
    real_init = fnn.Module.init

    def recording_init(self, rngs, *args):
        out = jax.jit(lambda r, *a: real_init(self, r, *a))(rngs, *args)
        captured[type(self).__name__] = jax.tree.map(np.asarray, out)
        return out

    jax_pred = JaxPredictor(cfg, radius=RADIUS, n_node_types=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init", recording_init)
        jax_pred.enable_pixels(hovernet_config={"batch_size": CHUNK})

    pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=6, device="cpu",
                          variables=jax.tree.map(np.asarray,
                                                 {"params": variables["params"]}))
    pred.enable_pixels(hovernet_config={"batch_size": CHUNK},
                       kimia_variables=captured["KimiaNet"],
                       hover_variables=captured["HoVerNet"])
    slides = [rng.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)
              for n in (3, 5)]
    return jax_pred, pred, slides


def test_slide_predictor_pixels_matches_jax(served):
    """Features to rtol 1e-3 / atol 1e-4 (f32 through two deep CNNs),
    node types exactly, probabilities to 1e-4."""
    jax_pred, pred, slides = served
    for px in slides:
        f_j, t_j = jax_pred.featurize(px)
        f_t, t_t = pred.featurize(px)
        assert f_t.shape == (len(px), 1024) and f_t.dtype == np.float32
        np.testing.assert_allclose(f_t, f_j, rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(t_t, t_j)
    want = jax_pred.predict_many_pixels(slides)
    got = pred.predict_many_pixels(slides)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert pred.timing["featurize_chunks"] >= 3 and pred.timing["calls"] >= 1


def test_feature_requests_are_grouping_invariant(served):
    """A response does not depend on which requests share its group, and
    the single-slide entry point agrees with the grouped one."""
    _, pred, _ = served
    rng = np.random.RandomState(3)
    a = (rng.randn(300, 1024).astype(np.float32),
         rng.randint(0, 6, 300).astype(np.int32))
    b = (rng.randn(40, 1024).astype(np.float32), None)
    grouped = pred.predict_many([a, b])
    np.testing.assert_allclose(grouped[0], pred.predict(*a), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(grouped[1], pred.predict_many([b])[0],
                               rtol=1e-5, atol=1e-6)
    pred.warmup(64)


def test_predictor_with_knn_impl_approx_reaches_the_knn(served, monkeypatch):
    """A predictor built with knn_impl 'approx' asks the KNN for 'approx'
    on every slide and answers as the exact one does (the port's approx
    returns the exact neighbours)."""
    from wsi_hgnn_tpu_torch.ops import knn as tknn

    _, pred, _ = served
    rng = np.random.RandomState(4)
    slides = [(rng.randn(n, 1024).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32)) for n in (40, 70)]
    want = pred.predict_many(slides)
    seen = []
    real = tknn.knn_lookup

    def recording(*args, impl="exact", **kw):
        seen.append(impl)
        return real(*args, impl=impl, **kw)

    monkeypatch.setattr(tknn, "knn_lookup", recording)
    monkeypatch.setattr(pred, "knn_impl", "approx")
    got = pred.predict_many(slides)
    assert seen == ["approx", "approx"]
    np.testing.assert_array_equal(got, want)


def test_entry_points_never_fall_back_to_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    cfg = {"GNN": dict(GNN)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlidePredictor(cfg, variables={"params": {}})
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        SlidePredictor(cfg, checkpoint_path=str(tmp_path / "ckpt"),
                       device="cpu")
    from wsi_hgnn_tpu_torch import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(["-config", str(ROOT / "configs/BRCA/"
                                  "HEAT4_kimia_classification.yml")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(["-mode", "graph_explain"])
    from wsi_hgnn_tpu_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    from wsi_hgnn_tpu_torch import train_mil

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mil.main(["--model", "abmil", "--feats-dir", str(tmp_path),
                        "--labels", str(tmp_path / "labels.csv")])
    # a model neither package implements raises before any weights load
    with pytest.raises(NotImplementedError, match="not implemented"):
        SlidePredictor({"GNN": dict(GNN, name="GraphSAGE")}, variables={},
                       device="cpu")


def _run_smoke(script: Path, cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: non-zero exit and no result line, in the repo and in a
    directory that holds the script alone."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = _run_smoke(script, cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_port_imports_no_jax():
    """Every module of the port (found by walking the package, so new
    ones are covered) and chip_smoke.py import without pulling in JAX,
    Flax, optax, the JAX package, PyYAML, msgpack, dgl, or cv2 and
    matplotlib (absent on the card machine)."""
    code = ("import importlib, pkgutil, sys, wsi_hgnn_tpu_torch as p;"
            " names = [m.name for m in pkgutil.walk_packages(p.__path__,"
            " 'wsi_hgnn_tpu_torch.')];"
            " [importlib.import_module(n) for n in names + ['chip_smoke']];"
            " assert {'wsi_hgnn_tpu_torch.pipeline.tiler',"
            " 'wsi_hgnn_tpu_torch.get_patches', 'wsi_hgnn_tpu_torch.native',"
            " 'wsi_hgnn_tpu_torch.models.featurizers.efficientnet',"
            " 'wsi_hgnn_tpu_torch.models.featurizers.effnetv2',"
            " 'wsi_hgnn_tpu_torch.explain', 'wsi_hgnn_tpu_torch.explain.gem',"
            " 'wsi_hgnn_tpu_torch.explain.gnn_explainer',"
            " 'wsi_hgnn_tpu_torch.explain.explain_graphs',"
            " 'wsi_hgnn_tpu_torch.models.mil',"
            " 'wsi_hgnn_tpu_torch.models.mil.graph_transformer',"
            " 'wsi_hgnn_tpu_torch.train_mil', 'wsi_hgnn_tpu_torch.collectives',"
            " 'wsi_hgnn_tpu_torch.parallel.mesh',"
            " 'wsi_hgnn_tpu_torch.parallel.dp',"
            " 'wsi_hgnn_tpu_torch.parallel.big_graph',"
            " 'wsi_hgnn_tpu_torch.parallel.dryrun',"
            " 'wsi_hgnn_tpu_torch.tools.convert_reference_checkpoint',"
            " 'wsi_hgnn_tpu_torch.tools.convert_reference_graphs'}"
            " <= set(names);"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'flax', 'optax', 'wsi_hgnn_tpu', 'yaml', 'msgpack',"
            " 'dgl', 'cv2', 'matplotlib')];"
            " assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
