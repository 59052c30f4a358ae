"""Port parity for the JAX package's remaining public helpers: the lattice
probes (data/lattice_loader.py::slide_regular_k, probe_lattice), the
probability-ranked binary AUC, the reference logger, the profiler trace
and annotation, the serve tool's `--knn-impl approx`, and the
subpackages' exported names; on the CPU."""
import importlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from wsi_hgnn_tpu import utils as jutils
from wsi_hgnn_tpu.data import lattice_loader as jll
from wsi_hgnn_tpu.graph import from_arrays as jax_from_arrays
from wsi_hgnn_tpu.train.metrics import binary_auc_from_probs as jax_auc
from wsi_hgnn_tpu_torch import profiling, utils
from wsi_hgnn_tpu_torch.data import probe_lattice, slide_regular_k
from wsi_hgnn_tpu_torch.graph import from_arrays
from wsi_hgnn_tpu_torch.train.metrics import binary_auc_from_probs
import port_threads  # noqa: F401  (torch threads per test worker)

ROOT = Path(__file__).resolve().parent.parent


def _knn_like(rng, n, k):
    """src-major out-degree-k edges to other nodes."""
    src = np.repeat(np.arange(n), k)
    dst = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                    for i in range(n)]).reshape(-1)
    return src, dst


def _slides(case):
    """(src, dst, n) per slide of one cohort case."""
    rng = np.random.RandomState(40)
    k = 4
    if case == "regular":
        return [(*_knn_like(rng, n, k), n) for n in (20, 33, 27)]
    if case == "irregular":       # ~15% of edges dropped, as from HNSW
        out = []
        for n in (20, 33, 27):
            src, dst = _knn_like(rng, n, k)
            keep = rng.rand(len(src)) > 0.15
            keep[0] = True
            out.append((src[keep], dst[keep], n))
        return out
    if case == "hub_skewed":      # a ring and one hub of out-degree 15
        n = 30
        src = np.concatenate([np.arange(n), np.zeros(15, int)])
        dst = np.concatenate([(np.arange(n) + 1) % n, np.arange(2, 17)])
        return [(src, dst, n)] * 3
    if case == "dst_out_of_range":
        src, dst = _knn_like(rng, 12, k)
        dst[5] = 12
        return [(src, dst, 12)]
    if case == "negative_src":
        src, dst = _knn_like(rng, 12, k)
        src[0] = -1
        return [(src, dst, 12)]
    raise ValueError(case)


def _graphs(build, slides):
    rng = np.random.RandomState(41)
    return [(build(rng.randn(n, 8).astype(np.float32),
                   src.astype(np.int32), dst.astype(np.int32),
                   node_type=np.zeros(n, np.int32), n_node_types=6), i % 2)
            for i, (src, dst, n) in enumerate(slides)]


@pytest.mark.parametrize("case", ["regular", "irregular", "hub_skewed",
                                  "dst_out_of_range", "negative_src"])
def test_slide_regular_k_and_probe_lattice_match_jax(case):
    """The cases of the JAX package's lattice tests: a k-regular cohort
    probes (k 4, the 256-node bucket); HNSW-shaped irregular rows still
    pack but are not regular; a hub blows the padding ratio (accepted at
    ratio 12); endpoints outside the real nodes never probe."""
    slides = _slides(case)
    mine, theirs = _graphs(from_arrays, slides), _graphs(jax_from_arrays,
                                                         slides)
    for (g, _), (jg, _) in zip(mine, theirs):
        assert slide_regular_k(g) == jll.slide_regular_k(jg)
    for ratio in (1.5, 12.0):
        assert (probe_lattice(mine, max_pad_ratio=ratio)
                == jll.probe_lattice(theirs, max_pad_ratio=ratio))
    want = {"regular": (4, (4, 256)), "irregular": (None, (4, 256)),
            "hub_skewed": (None, None), "dst_out_of_range": (None, None),
            "negative_src": (None, None)}[case]
    assert (slide_regular_k(mine[0][0]), probe_lattice(mine)) == want
    if case == "hub_skewed":
        assert probe_lattice(mine, max_pad_ratio=12.0) is not None


def test_binary_auc_from_probs_matches_jax():
    rng = np.random.RandomState(42)
    targets = rng.randint(0, 2, 60)
    probs = rng.rand(60, 2)
    probs /= probs.sum(1, keepdims=True)
    probs[::7, 1] = probs[0, 1]          # tied scores
    got = binary_auc_from_probs(targets, probs)
    assert got == pytest.approx(jax_auc(targets, probs), abs=1e-12)
    assert 0.0 <= got <= 1.0
    assert np.isnan(binary_auc_from_probs(np.zeros(4, int), probs[:4]))


def test_get_logger_is_the_reference_logger():
    """The name, level, one handler however often it is asked for, and the
    format, as the JAX package's copy sets them."""
    logger = utils.get_logger()
    assert utils.get_logger() is logger is jutils.get_logger()
    assert logger.name == "main-logger" and logger.level == logging.INFO
    assert len(logger.handlers) == 1
    fmt = logger.handlers[0].formatter._fmt
    assert fmt == ("[%(asctime)s %(levelname)s %(filename)s line "
                   "%(lineno)d %(process)d] %(message)s")
    # a fresh logger object gets the same single handler from the port
    logging.Logger.manager.loggerDict.pop("main-logger")
    fresh = utils.get_logger()
    assert fresh is not logger and len(fresh.handlers) == 1
    assert fresh.handlers[0].formatter._fmt == fmt
    logging.Logger.manager.loggerDict.pop("main-logger")
    assert jutils.get_logger().handlers[0].formatter._fmt == fmt


def test_profiling_trace_writes_the_annotation(tmp_path, caplog):
    """trace() over a block writes one Chrome-trace file that holds the
    annotate() range and the ops run inside it; with create_perfetto_link
    it logs the file to open in ui.perfetto.dev."""
    from wsi_hgnn_tpu_torch.ops.knn import knn_lookup

    f = torch.randn(64, 8)
    with caplog.at_level(logging.WARNING):
        with profiling.trace(str(tmp_path), create_perfetto_link=True):
            with profiling.annotate("knn"):
                knn_lookup(f, 4)
    files = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "knn" in names
    assert "aten::sort" in names
    assert str(files[0]) in caplog.text and "ui.perfetto.dev" in caplog.text


def test_stage_timer_reset():
    timer = profiling.StageTimer()
    with timer.stage("a"):
        pass
    timer.reset()
    assert not timer.totals and not timer.counts


def test_serve_tool_takes_knn_impl_approx(monkeypatch):
    """`--knn-impl approx` parses, as in the JAX tool, and reaches the
    predictor (tests/test_torch_serve.py follows it to the KNN)."""
    from wsi_hgnn_tpu_torch import serve
    from wsi_hgnn_tpu_torch.tools import serve as tool

    class Stop(Exception):
        pass

    seen = {}

    def predictor(config, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(serve, "SlidePredictor", predictor)
    cfg = str(ROOT / "configs/BRCA/HEAT4_kimia_classification.yml")
    for impl in ("exact", "approx", "pallas"):
        with pytest.raises(Stop):
            tool.main(["-config", cfg, "--knn-impl", impl, "--device", "cpu"])
        assert seen["knn_impl"] == impl
    with pytest.raises(SystemExit):
        tool.main(["-config", cfg, "--knn-impl", "hnsw"])


def test_checkpoint_config_and_stats_readers_match_jax(tmp_path):
    """load_config and load_stats read what either package wrote."""
    from wsi_hgnn_tpu.train.checkpoint import CheckpointManager as JaxManager
    from wsi_hgnn_tpu_torch.train.checkpoint import CheckpointManager

    mine = CheckpointManager(str(tmp_path))
    mine.save_config({"GNN": {"name": "HEAT4"}})
    mine.append_stats({"Epoch": 1, "Train Loss: ": 0.5})
    mine.append_stats({"Epoch": 2, "Train Loss: ": 0.25})
    theirs = JaxManager(str(tmp_path))
    assert mine.load_config() == theirs.load_config()
    assert list(mine.load_stats()) == list(theirs.load_stats())
    assert [json.loads(line)["Epoch"] for line in mine.load_stats()] == [1, 2]


def test_typed_graph_replace_feat():
    g = from_arrays(np.zeros((3, 2), np.float32), np.array([0, 1]),
                    np.array([1, 2]))
    h = g.replace_feat(np.ones((g.feat.shape[0], 2), np.float32))
    assert (h.feat == 1).all() and (g.feat == 0).all() and h.src is g.src


# names of the JAX package's subpackages that have no counterpart in the
# port, each for the reason ROADMAP.md's table of them gives
RULED_OUT = {
    "parallel": {"data_sharded", "replicated"},
    "train": {"TrainState"},
    "models.mil": {"make_simclr_train_step"},
}


@pytest.mark.parametrize("sub", ["graph", "data", "models",
                                 "models.featurizers", "models.mil", "ops",
                                 "parallel", "pipeline", "train", "explain"])
def test_subpackages_export_what_jax_exports(sub):
    jax_pkg = importlib.import_module(f"wsi_hgnn_tpu.{sub}")
    port = importlib.import_module(f"wsi_hgnn_tpu_torch.{sub}")
    names = set(getattr(jax_pkg, "__all__", None)
                or [n for n in vars(jax_pkg) if not n.startswith("_")])
    missing = sorted(n for n in names - RULED_OUT.get(sub, set())
                     if not hasattr(port, n))
    assert not missing
