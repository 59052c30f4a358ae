"""Port parity of the data and config layers (wsi_hgnn_tpu_torch/config.py
YAML reader, data/datasets.py, data/loader.py, data/lattice_loader.py,
train/metrics.py) against the JAX package on the same inputs, on the
CPU."""
import glob
import importlib
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wsi_hgnn_tpu.config import load_config as jax_load_config
from wsi_hgnn_tpu.data import datasets as jds
from wsi_hgnn_tpu.data import lattice_loader as jll
from wsi_hgnn_tpu.models.lattice import build_lattice_device as jax_build
from wsi_hgnn_tpu_torch import config as tconfig
from wsi_hgnn_tpu_torch.data import datasets as tds
from wsi_hgnn_tpu_torch.data import lattice_loader as tll
from wsi_hgnn_tpu_torch.data.loader import prefetched_batches
import port_threads  # noqa: F401  (torch threads per test worker)

# the packages' train/__init__ export a function named `metrics`
jmetrics = importlib.import_module("wsi_hgnn_tpu.train.metrics")
tmetrics = importlib.import_module("wsi_hgnn_tpu_torch.train.metrics")
ROOT = Path(__file__).resolve().parent.parent
D, RADIUS = 16, 4  # k = 3


def _same_tree(a, b):
    """Equal values, types and key order, OrderedDict maps in the port."""
    if isinstance(a, dict):
        assert isinstance(b, OrderedDict), type(b)
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("folder", ["BRCA", "COAD", "ESCA",
                                    "GraphConstruction"])
def test_yaml_reader_matches_pyyaml(folder):
    files = sorted(glob.glob(str(ROOT / "configs" / folder / "*.yml")))
    assert files
    for f in files:
        _same_tree(jax_load_config(f), tconfig.load_config(f))


def test_yaml_reader_scalars_and_structure():
    text = ("top:  # a comment\n"
            "  a: 1e-5\n"
            "  b: 0.00001  # trailing\n"
            "  c: -3\n"
            "  d: 'it''s'\n"
            "  e: \"x # not a comment\"\n"
            "  f: [\"pos\", 'neg', 2]\n"
            "  g:\n"
            "  h: []\n"
            "  nested:\n"
            "    deeper: False\n"
            "last: homo-graph\n")
    got = tconfig.loads_config(text)
    assert got == {"top": {"a": 1e-5, "b": 1e-5, "c": -3, "d": "it's",
                           "e": "x # not a comment", "f": ["pos", "neg", 2],
                           "g": None, "h": [], "nested": {"deeper": False}},
                   "last": "homo-graph"}
    assert list(got["top"]) == ["a", "b", "c", "d", "e", "f", "g", "h",
                                "nested"]


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n",            # block sequence
    "a: &x 1\n",              # anchor
    "a:\n\tb: 1\n",           # tab indentation
    "a: [[1], 2]\n",          # nested flow list
    "a: {b: 1}\n",            # flow map
    "a: yes\n",               # YAML 1.1 bool word
    "a: null\n",
    "a: \"x\\n\"\n",          # escape
    "a: 010\n",               # octal in YAML 1.1
    "a: 1\n    b: 2\n",       # indentation under a scalar
    "a: 'open\n",
    "- 1\n",
    "",
])
def test_yaml_reader_rejects_what_it_does_not_support(text):
    with pytest.raises(tconfig.ConfigSyntaxError):
        tconfig.loads_config(text)


def _list_file(tmp_path, name, lines):
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("task", ["staging", "typing_brca", "typing_esca",
                                  "classification"])
def test_dataset_labels_match_jax(tmp_path, task):
    """Every case of the shipped label tables, behind barcoded file
    names, gets the JAX dataset's label (labels need no graph file)."""
    table = {"staging": "data/staging_BRCA.txt",
             "typing_brca": "data/typing_BRCA.txt",
             "typing_esca": "data/ESCA_typing.txt",
             "classification": "data/typing_BRCA.txt"}[task]
    sep = "," if "ESCA" in table else "\t"
    cases = sorted({l.split(sep)[0] for l in
                    (ROOT / table).read_text().splitlines() if l.strip()})
    paths = [f"/slides/{c}-01Z-00-DX{i % 3}.npz" for i, c in enumerate(cases)]
    lst = _list_file(tmp_path, "split.txt", paths)
    if task == "classification":
        normal = _list_file(tmp_path, "normal.txt",
                            [c + "-01Z" for c in cases[::3]])
        pair = (jds.GraphDataset(lst, normal, "BRCA", "train"),
                tds.GraphDataset(lst, normal, "BRCA", "train"))
    else:
        cls = "TCGACancerStageDataset" if task == "staging" else \
            "TCGACancerTypingDataset"
        label_path = str(ROOT / table)
        pair = (getattr(jds, cls)(lst, label_path, "eval"),
                getattr(tds, cls)(lst, label_path, "eval"))
    j, t = pair
    assert len(t) == len(j) == len(cases)

    def outcome(ds, i):  # a label, or the table's undefined-label error
        try:
            return ds.label_of(i)
        except ValueError as e:
            return str(e)

    want = [outcome(j, i) for i in range(len(j))]
    assert [outcome(t, i) for i in range(len(t))] == want
    assert len({w for w in want if isinstance(w, int)}) >= 2


def _assert_graphs_equal(a, b):
    for field in ("feat", "node_type", "node_graph", "node_mask", "src",
                  "dst", "esign", "sim", "edge_mask"):
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.n_graphs, a.n_node_types, a.n_edge_types) == (
        b.n_graphs, b.n_node_types, b.n_edge_types)


@pytest.mark.parametrize("hetero", [True, False])
def test_npz_roundtrip_across_packages(tmp_path, hetero):
    rng = np.random.RandomState(4)
    n, e = 37, 90
    args = (rng.randn(n, D).astype(np.float32), rng.randint(0, n, e),
            rng.randint(0, n, e))
    kw = dict(node_type=rng.randint(0, 6, n), esign=rng.randint(0, 2, e),
              sim=rng.randn(e).astype(np.float32), n_node_types=6,
              is_hetero=hetero)
    tds.save_graph_npz(tmp_path / "t.npz", *args, **kw)
    jds.save_graph_npz(tmp_path / "j.npz", *args, **kw)
    for f in ("t.npz", "j.npz"):
        _assert_graphs_equal(jds.load_graph_npz(tmp_path / f),
                             tds.load_graph_npz(tmp_path / f))


def _cohort(tmp_path, n_slides=7, drop=0.0, seed=0):
    """Constructor-shaped slides (KNN lattice, radius 4) written as npz;
    with drop > 0 a share of edges is removed, leaving irregular rows."""
    rng = np.random.RandomState(seed)
    paths, normals = [], []
    for i in range(n_slides):
        n = rng.randint(20, 40)
        feat = rng.randn(n, D).astype(np.float32) + (i % 2) * 1.5
        types = rng.randint(0, 6, n).astype(np.int32)
        g = jax_build(jnp.asarray(feat[None]), jnp.asarray(types[None]),
                      jnp.ones((1, n), bool), RADIUS, 6)
        k = g.idx.shape[2]
        src = np.repeat(np.arange(n), k)
        dst = np.asarray(g.idx[0]).reshape(-1)
        keep = rng.rand(n * k) >= drop
        keep[0] = True
        barcode = f"TCGA-{i:02d}-0000-01Z-00-DX1"
        p = str(tmp_path / f"{barcode}.npz")
        tds.save_graph_npz(p, feat, src[keep], dst[keep], node_type=types,
                           esign=np.asarray(g.esign[0]).reshape(-1)[keep],
                           sim=np.asarray(g.sim[0]).reshape(-1)[keep])
        paths.append(p)
        if i % 2 == 0:
            normals.append(barcode[:16])
    return (_list_file(tmp_path, "train.txt", paths),
            _list_file(tmp_path, "normal.txt", normals))


@pytest.mark.parametrize("drop", [0.0, 0.15])
def test_probe_pack_and_loader_match_jax(tmp_path, drop):
    """Probe results, pack_slide and the LatticeLoader's batch order and
    contents (tail padding, masked irregular rows) equal the JAX
    package's; the port's batches arrive as torch with int64 indices."""
    lst, normal = _cohort(tmp_path, drop=drop)
    j_ds = jds.GraphDataset(lst, normal, "BRCA", "train")
    t_ds = tds.GraphDataset(lst, normal, "BRCA", "train")
    j_probe = jll.probe_lattice_and_capacities(j_ds, 3)
    t_probe = tll.probe_lattice_and_capacities(t_ds, 3)
    assert t_probe == j_probe and t_probe[2] is not None
    k, cap = t_probe[2]
    for i in range(len(t_ds)):
        assert tll.slide_lattice_geometry(t_ds[i][0]) == \
            jll.slide_lattice_geometry(j_ds[i][0])
        for a, b in zip(tll.pack_slide(t_ds[i][0], k, cap),
                        jll.pack_slide(j_ds[i][0], k, cap)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if drop:
        short_rows = [(p[6].sum(1) < k) & p[2] for p in
                      (tll.pack_slide(t_ds[i][0], k, cap)
                       for i in range(len(t_ds)))]
        assert any(r.any() for r in short_rows)
    j_loader = jll.LatticeLoader(j_ds, 3, k, cap, shuffle=True, seed=5)
    t_loader = tll.LatticeLoader(t_ds, 3, k, cap, shuffle=True, seed=5)
    padded = 0
    for _ in range(2):  # two epochs: the shuffle stream continues alike
        for (jg, jl, jw), (tg, tl, tw) in zip(j_loader, t_loader):
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tw, jw)
            padded += int((tw == 0).sum())
            for a, b in zip(tg, jg):
                assert isinstance(a, torch.Tensor)
                if np.issubdtype(np.asarray(b).dtype, np.integer):
                    assert a.dtype == torch.int64
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert padded == 2 * 2   # 7 slides in batches of 3: a tail of 1 an epoch


@pytest.mark.parametrize("kind", ["graph", "lattice"])
def test_short_tail_repeats_the_first_slide_at_weight_zero(tmp_path,
                                                           monkeypatch, kind):
    """A tail of one slide in a batch of three: both loaders pad it with
    the first slide at label 0 and weight 0, and the lattice loader packs
    that slide once."""
    from wsi_hgnn_tpu_torch.data.loader import GraphLoader

    lst, normal = _cohort(tmp_path, n_slides=2)
    ds = tds.GraphDataset(lst, normal, "BRCA", "train")
    packed = []
    pack = tll.pack_slide
    monkeypatch.setattr(tll, "pack_slide",
                        lambda g, *a: packed.append(g) or pack(g, *a))
    if kind == "lattice":
        k, cap = tll.probe_lattice(ds)
        loader = tll.LatticeLoader(ds, 3, k, cap, shuffle=False)
    else:
        loader = GraphLoader(ds, 3, shuffle=False, prefetch=0)
    g, labels, weights = loader._make_batch([1])
    np.testing.assert_array_equal(labels, [ds[1][1], 0, 0])
    np.testing.assert_array_equal(weights, [1.0, 0.0, 0.0])
    if kind == "lattice":
        assert len(packed) == 1
        for leaf in g:
            np.testing.assert_array_equal(leaf[1], leaf[0])
            np.testing.assert_array_equal(leaf[2], leaf[0])
    else:
        n = int(np.asarray(ds[1][0].node_mask).sum())
        assert g.n_graphs == 3
        np.testing.assert_array_equal(np.bincount(
            np.asarray(g.node_graph)[np.asarray(g.node_mask)]), [n] * 3)


def test_probe_rejects_what_does_not_pack():
    from wsi_hgnn_tpu_torch.graph.typed_graph import from_arrays

    feat = np.zeros((6, D), np.float32)
    src = np.repeat(np.arange(6), 2).astype(np.int32)
    dst = ((src + 1) % 6).astype(np.int32)
    assert tll.slide_lattice_geometry(from_arrays(feat, src, dst)) == (2, 12, 6)
    bad = dst.copy()
    bad[3] = 6
    assert tll.slide_lattice_geometry(from_arrays(feat, src, bad)) is None
    # a hub: one node with out-degree 12, the rest 1 -> padding ratio 6
    hub_src = np.concatenate([np.zeros(12, np.int32),
                              np.arange(1, 6, dtype=np.int32)])
    hub = [(from_arrays(feat, hub_src, (hub_src + 1) % 6), 0)]
    assert tll.probe_lattice_and_capacities(hub, 1)[2] is None
    with pytest.raises(ValueError, match="exceeds lattice"):
        tll.pack_slide(hub[0][0], 2, 256)


def test_prefetch_reraises_worker_errors_and_releases_the_worker():
    def boom(i):
        if i == 2:
            raise ValueError("corrupt slide")
        return i * 10

    for prefetch in (2, 0):
        got = []
        with pytest.raises(ValueError, match="corrupt slide"):
            for x in prefetched_batches(range(5), boom, prefetch=prefetch):
                got.append(x)
        assert got == [0, 10]

    before = threading.active_count()
    it = prefetched_batches(range(50), lambda i: i, prefetch=1)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("average,classes", [("binary", 2), ("macro", 2),
                                             ("macro", 4)])
def test_metrics_match_jax(average, classes):
    rng = np.random.RandomState(classes)
    for n in (5, 40, 200):
        probs = rng.dirichlet(np.ones(classes), n).astype(np.float32)
        probs[: n // 4] = probs[0]  # ties in the ranking
        targets = rng.randint(0, classes, n)
        want = jmetrics.metrics(probs, targets, average)
        got = tmetrics.metrics(probs, targets, average)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert tmetrics.accuracy(probs, targets) == \
            jmetrics.accuracy(probs, targets)
    one_class = np.zeros(6, int)
    assert np.isnan(tmetrics.binary_auc_from_scores(one_class, np.ones(6)))
