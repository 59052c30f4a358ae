"""Port parity of the explainers (wsi_hgnn_tpu_torch/explain,
data/datasets.py::C16EvalDataset, main.py -mode graph_explain) against
the JAX package on the CPU: the same numpy slide, the same weights carried
across by `convert`.

GEM and HetGEM scores to rtol 1e-4 / atol 1e-5 for every zoo family at a
tiny width (with a tail chunk, and a slide whose deletions change the
relation and node-type occupancy), the flat leave-one-out batch against
one forward per deletion, a 30-step GNNExplainer from JAX's initial
logits to atol 1e-4 (tests/test_explain.py's trajectory bound), the
whole ExplainGraph.eval on a synthetic Camelyon16 layout, and the
heatmap's colours and rectangles against matplotlib and cv2."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu import graph as jgraph
from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu.explain import gem as jgem
from wsi_hgnn_tpu.explain.gnn_explainer import GNNExplainer as JGNNExplainer
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import parse_gnn_model
from wsi_hgnn_tpu_torch.explain import (GemExplainer, GNNExplainer,
                                        HetGemExplainer, points_in_polygon)
from wsi_hgnn_tpu_torch.explain.gem import LooBatch, _delete_node
from wsi_hgnn_tpu_torch.graph import from_arrays, to_homogeneous
import port_threads  # noqa: F401  (torch threads per test worker)

D, T, CPU = 8, 3, torch.device("cpu")
_BASE = {"in_dim": D, "hidden_dim": 16, "out_dim": 3, "num_layers": 2,
         "n_node_types": T, "feat_drop": 0.0}
FAMILIES = {
    "GCN": dict(_BASE, name="GCN", graph_pooling_type="att"),
    "GAT": dict(_BASE, name="GAT", num_heads=2, num_out_heads=1,
                attn_drop=0.0, negative_slope=0.2, graph_pooling_type="mean",
                residual=True),
    "GIN": dict(_BASE, name="GIN", num_layers=3, num_mlp_layers=2,
                graph_pooling_type="att", neighbor_pooling_type="mean"),
    "GCN_NTPool": dict(_BASE, name="GCN_NTPool", graph_pooling_type="mean"),
    "HetRGCN": dict(_BASE, name="HetRGCN", graph_pooling_type="mean",
                    edge_types=["pos", "neg"]),
    "HGT": dict(_BASE, name="HGT", num_heads=2, graph_pooling_type="mean"),
    "HEAT2": dict(_BASE, name="HEAT2", n_heads=2, graph_pooling_type="mean"),
    "HEAT4": dict(_BASE, name="HEAT4", n_heads=2, graph_pooling_type="mean"),
    "GCN_asap": dict(_BASE, name="GCN", num_layers=2,
                     graph_pooling_type="asap", pool_k=4),
}
N_REAL = 21       # 3 chunks of 8: the last one a padded tail


def slide(hetero: bool, seed: int = 0):
    """One padded slide of N_REAL nodes: node type 2 has a single node
    (node 5), and node 7 carries every edge of its relation, so deleting
    either changes the slide's occupancy."""
    rng = np.random.RandomState(seed)
    n, e = N_REAL, 4 * N_REAL
    types = rng.randint(0, 2, n)
    types[5] = 2
    src, dst = rng.randint(0, n, e), rng.randint(0, n, e)
    esign = rng.randint(0, 2, e)
    src[:3], dst[:3], esign[:3] = 7, (1, 2, 3), 1
    return from_arrays(rng.randn(n, D).astype(np.float32) + 0.3, src, dst,
                       node_type=types, esign=esign,
                       sim=rng.uniform(-1, 1, e),
                       n_node_types=T if hetero else 1,
                       add_self_loops=not hetero, node_capacity=32,
                       edge_capacity=128)


def jax_graph(g):
    arr = {k: jnp.asarray(np.asarray(getattr(g, k))) for k in (
        "feat", "node_type", "node_graph", "node_mask", "src", "dst",
        "esign", "sim", "edge_mask")}
    return jgraph.TypedGraph(**arr, n_graphs=g.n_graphs,
                             n_node_types=g.n_node_types,
                             n_edge_types=g.n_edge_types,
                             edges_sorted=g.edges_sorted)


@functools.lru_cache(maxsize=None)
def family(name):
    """(jax model_fn, port model_fn, port model, host slide)."""
    section = FAMILIES[name]
    jm, hetero = jax_parse_gnn_model(section)
    tm, _ = parse_gnn_model(section)
    convert.init_flax_like_(tm, seed=2)
    variables = jax.tree.map(jnp.asarray, convert.to_flax_variables(tm))
    tm.eval()

    def jfn(g, feat_override=None):
        if feat_override is not None:
            g = g.replace(feat=feat_override)
        gg = g if hetero else jgraph.to_homogeneous(g)
        return jm.apply(variables, gg, train=False)

    def tfn(g, feat_override=None):
        if feat_override is not None:
            g = g.replace(feat=feat_override)
        return tm(g if hetero else to_homogeneous(g))

    return jfn, tfn, tm, slide(hetero)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gem_scores_match_jax(name):
    """GemExplainer (homogeneous slides) or HetGemExplainer.flat_scores
    (typed slides), as ExplainGraph picks, equal to JAX's."""
    jfn, tfn, _, host = family(name)
    g_t = host.to_torch(CPU)
    label = 1
    if host.is_homogeneous:
        want = jgem.GemExplainer(jax_graph(host), jfn, label,
                                 batch_size=8).explain_node()
        got = GemExplainer(g_t, tfn, label, batch_size=8).explain_node()
    else:
        want = jgem.HetGemExplainer(jax_graph(host), jfn, label,
                                    batch_size=8).flat_scores()
        got = HetGemExplainer(g_t, tfn, label, batch_size=8).flat_scores()
    assert got.shape == (N_REAL,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.ptp(want) > 1e-4


@pytest.mark.parametrize("name", ["HEAT4", "HetRGCN", "GCN_NTPool",
                                  "GCN_asap"])
def test_flat_loo_batch_equals_single_forwards(name):
    """One forward of the flat B-copy batch equals B forwards of single
    slides, each with its node deleted (deletions 5 and 7 change the
    occupancy)."""
    _, tfn, _, host = family(name)
    g = host.to_torch(CPU)
    if not host.is_homogeneous:
        g = g.replace(esign=torch.ones_like(g.esign))
    ids = torch.tensor([0, 5, 7, 20, 20])
    with torch.no_grad():
        got = tfn(LooBatch(g, len(ids)).delete(ids))
        want = torch.cat([tfn(_delete_node(g, int(i))) for i in ids])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["HEAT4", "HGT", "GCN_NTPool"])
def test_flat_batch_counts_occupancy_per_graph_only_when_marked(name):
    """The leave-one-out batch is marked per_graph_occupancy; the same
    batch unmarked counts relation and type occupancy over all copies,
    as training does, and no longer equals the single forwards (deletion
    5 empties node type 2 in its copy only)."""
    _, tfn, _, host = family(name)
    g = host.to_torch(CPU).replace(esign=torch.ones_like(host.to_torch(
        CPU).esign))
    ids = torch.tensor([0, 5])
    batch = LooBatch(g, len(ids)).delete(ids)
    assert batch.per_graph_occupancy and not g.per_graph_occupancy
    with torch.no_grad():
        want = torch.cat([tfn(_delete_node(g, int(i))) for i in ids])
        pooled = tfn(batch.replace(per_graph_occupancy=False))
    assert not torch.allclose(pooled[1], want[1], rtol=1e-3, atol=1e-4)


def test_het_gem_groups_by_type_and_unsorts():
    _, tfn, _, host = family("HEAT4")
    het = HetGemExplainer(host.to_torch(CPU).replace(edges_sorted=True), tfn,
                          0, batch_size=8)
    assert int(het.graph.esign.min()) == 1 and not het.graph.edges_sorted
    by_type = het.explain_node()
    types = np.asarray(host.node_type)[:N_REAL]
    for t in range(T):
        assert by_type[str(t)].shape == ((types == t).sum(),)


@pytest.mark.parametrize("name", ["GCN", "HEAT4"])
def test_gnn_explainer_trajectory_matches_jax(name):
    """30 Adam steps from JAX's initial logits land on JAX's masks (atol
    1e-4); the model's parameters are frozen only during the loop."""
    jfn, tfn, tm, host = family(name)
    epochs, seed = 30, 9
    want_g, want_node = JGNNExplainer(jax_graph(host), jfn, num_hops=1,
                                      epochs=epochs, seed=seed
                                      ).explain_node(None)
    n_real = N_REAL
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    std = np.sqrt(2.0) * np.sqrt(2.0 / (2 * n_real))
    init = (np.asarray(jax.random.normal(k1, (host.num_nodes,))) * 0.1,
            np.asarray(jax.random.normal(k2, (host.num_edges,))) * std)
    got_g, got_node = GNNExplainer(host.to_torch(CPU), tfn, num_hops=1,
                                   epochs=epochs, model=tm,
                                   init_logits=init).explain_node(None)
    np.testing.assert_allclose(got_node, want_node, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_g.edge_weight.numpy(),
                               np.asarray(want_g.edge_weight), atol=1e-4,
                               rtol=0)
    assert np.abs(want_node - 1 / (1 + np.exp(-init[0][:n_real]))).max() > 1e-3
    assert all(p.requires_grad for p in tm.parameters())


def test_gnn_explainer_draws_its_init_from_its_seed():
    _, tfn, tm, host = family("GCN")
    runs = [GNNExplainer(host.to_torch(CPU), tfn, 1, epochs=2, seed=s,
                         model=tm).explain_node(None)[1] for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert runs[0].shape == (N_REAL,)


def test_points_in_polygon_golden():
    square = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], float)
    pts = np.array([[5, 5], [15, 5], [-1, -1], [9.99, 9.99], [5, 20]], float)
    np.testing.assert_array_equal(points_in_polygon(pts, square),
                                  [True, False, False, True, False])


# ---------------------------------------------------------------------------
# the heatmap: colours against matplotlib, rectangles against cv2
# ---------------------------------------------------------------------------
def test_wistia_equals_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    from wsi_hgnn_tpu_torch.explain.explain_graphs import wistia

    rng = np.random.RandomState(0)
    for vals in (rng.uniform(0, 1, 4000).astype(np.float32),
                 rng.uniform(-0.5, 1.5, 4000),
                 np.array([0.0, 1.0, 1 / 256, 255 / 256, -1e-9, 1 + 1e-9,
                           np.nan, np.inf, -np.inf], np.float32),
                 np.linspace(0, 1, 1025)):
        norm = matplotlib.colors.Normalize(vmin=0, vmax=1)
        want = matplotlib.colormaps["Wistia"](norm(vals))[:, :3]
        np.testing.assert_array_equal(wistia(vals), want)


def _heat_inputs():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (300, 400, 3)).astype(np.uint8)
    coords = [(int(x), int(y)) for x, y in rng.randint(-20, 390, (40, 2))]
    scores = rng.uniform(-0.2, 1.2, 40).astype(np.float32)
    polys = [np.array([[40, 40], [1200, 80], [1500, 1100], [200, 900],
                       [60, 400]], float),
             np.array([[10.5, 1000.7], [700.2, 1150.9], [1580.0, 20.0]])]
    return img, scores, coords, polys


def test_heatmap_rectangles_equal_cv2_and_polylines_within_band():
    """Rectangles (colour through matplotlib, fill through
    cv2.rectangle(FILLED)) pixel for pixel; the 4 px open polylines
    within 3 px of cv2's (both directions)."""
    cv2 = pytest.importorskip("cv2")
    matplotlib = pytest.importorskip("matplotlib")
    from scipy import ndimage

    from wsi_hgnn_tpu_torch.explain.explain_graphs import draw_heatmap

    img, scores, coords, polys = _heat_inputs()
    s, level = 32, 2
    got = draw_heatmap(img, scores, coords, s, [], level)
    want = np.array(img, copy=True)
    norm = matplotlib.colors.Normalize(vmin=0, vmax=1)
    colours = matplotlib.colormaps["Wistia"](norm(scores))[:, :3]
    for (x, y), cl in zip(coords, colours):
        want = cv2.rectangle(want, (x + s, y), (x, y + s),
                             [float(c) * 255 for c in cl], cv2.FILLED)
    np.testing.assert_array_equal(got, want)

    got = draw_heatmap(img, scores, coords, s, polys, level)
    for poly in polys:
        pts = (poly.reshape((-1, 1, 2)) / 2 ** level).astype(np.int32)
        want = cv2.polylines(want, [pts], False, (255, 0, 0), thickness=4)
    red_got = np.all(got == (255, 0, 0), -1) & ~np.all(img == (255, 0, 0), -1)
    red_want = (np.all(want == (255, 0, 0), -1)
                & ~np.all(img == (255, 0, 0), -1))
    near = np.ones((7, 7), bool)
    assert red_got.sum() > 0.5 * red_want.sum() > 0
    assert not (red_got & ~ndimage.binary_dilation(red_want, near)).any()
    assert not (red_want & ~ndimage.binary_dilation(red_got, near)).any()
    off = ~(ndimage.binary_dilation(red_got | red_want, near))
    np.testing.assert_array_equal(got[off], want[off])


# ---------------------------------------------------------------------------
# the whole loop on a synthetic Camelyon16 layout
# ---------------------------------------------------------------------------
_XML = """<?xml version="1.0"?>
<ASAP_Annotations><Annotations><Annotation Type="Polygon">
<Coordinates>
<Coordinate Order="0" X="0" Y="0"/>
<Coordinate Order="1" X="1100" Y="0"/>
<Coordinate Order="2" X="1024" Y="1300"/>
<Coordinate Order="3" X="0" Y="1024"/>
</Coordinates>
</Annotation></Annotations></ASAP_Annotations>
"""


def c16_layout(tmp_path, section, hetero, slides=("test_001", "test_002")):
    """A 4x4 tile grid per slide (level 2, patch 256), the annotation over
    the upper-left block, graphs with a planted tumour channel, a
    Normal slide the dataset must skip, and a version-1 checkpoint of
    seeded weights written by the port. Returns the config dict."""
    from PIL import Image

    from wsi_hgnn_tpu_torch.data import save_graph_npz
    from wsi_hgnn_tpu_torch.train.checkpoint import CheckpointManager

    dirs = {k: tmp_path / k for k in ("patches", "wsis", "annots", "graphs")}
    for d in dirs.values():
        d.mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for slide_name in slides + ("normal_001",):
        pd = dirs["patches"] / slide_name
        pd.mkdir()
        tumour = np.zeros(16, np.float32)
        for i in range(16):
            col, row = i // 4, i % 4
            (pd / f"{col}_{row}.jpeg").touch()
            tumour[i] = float(col < 2 and row < 2)
        feat = rng.randn(16, D).astype(np.float32) * 0.1
        feat[:, 0] = tumour * 3.0
        src = np.repeat(np.arange(16), 3)
        dst = (src + np.tile([1, 4, 5], 16)) % 16
        save_graph_npz(str(dirs["graphs"] / f"{slide_name}.npz"), feat, src,
                       dst, node_type=rng.randint(0, T, 16),
                       esign=rng.randint(0, 2, len(src)),
                       sim=rng.uniform(-1, 1, len(src)), n_node_types=T,
                       is_hetero=hetero)
        paths.append(str(dirs["graphs"] / f"{slide_name}.npz"))
        Image.new("RGB", (2048, 2048), (200, 120, 180)).save(
            dirs["wsis"] / f"{slide_name}.png")
        (dirs["annots"] / f"{slide_name}.xml").write_text(_XML)
    (tmp_path / "eval_list.txt").write_text("\n".join(paths))
    (tmp_path / "reference.csv").write_text(
        "NAME,LABEL\n" + "\n".join(f"{s},Tumor" for s in slides)
        + "\nnormal_001,Normal\n")
    cfg = {
        "datasets": {"dataset": "C16",
                     "patches_path": str(dirs["patches"]) + "/",
                     "wsi_path": str(dirs["wsis"]) + "/",
                     "eval_path": str(tmp_path / "eval_list.txt"),
                     "reference_csv": str(tmp_path / "reference.csv")},
        "checkpoint": {"path": str(tmp_path / "ckpt")},
        "GNN": dict(section),
        "eval": {"explainer_name": "GemExplainer",
                 "explain_path": str(tmp_path / "plots") + "/",
                 "annotation_path": str(dirs["annots"]) + "/",
                 "level": 2, "patch_size": 256},
    }
    model, _ = parse_gnn_model(cfg["GNN"])
    variables = convert.to_flax_variables(convert.init_flax_like_(model, 4))
    CheckpointManager(cfg["checkpoint"]["path"]).write_new_version(
        cfg, {"params": variables["params"],
              "batch_stats": variables.get("batch_stats", {})}, {"Epoch": 1})
    return cfg


def _yaml(cfg) -> str:
    """The config dict as the YAML subset both packages read."""
    lines = []
    for sec, body in cfg.items():
        lines.append(f"{sec}:")
        for k, v in body.items():
            lines.append(f"  {k}: {v!r}" if isinstance(v, str)
                         else f"  {k}: {v}")
    return "\n".join(lines).replace("'", '"') + "\n"


def _recording(cls, monkeypatch):
    """Record every explain_one result of `cls` (name order)."""
    seen = []
    orig = cls.explain_one

    def explain_one(self, graph, label):
        out = orig(self, graph, label)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, "explain_one", explain_one)
    return seen


@pytest.mark.parametrize("name", ["GCN", "HEAT4"])
def test_explain_graph_eval_matches_jax(tmp_path, name, capsys, monkeypatch):
    """`main.py -mode graph_explain -device cpu` against the JAX
    ExplainGraph on one layout and checkpoint: the same tumour slides
    (the Normal one skipped), the same per-slide scores and AUCs, the
    thumbnails and overlays written."""
    pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    from wsi_hgnn_tpu.explain.explain_graphs import ExplainGraph as JExplain
    from wsi_hgnn_tpu_torch.explain import ExplainGraph
    from wsi_hgnn_tpu_torch.main import main

    cfg = c16_layout(tmp_path, FAMILIES[name], name == "HEAT4")
    (tmp_path / "explain.yml").write_text(_yaml(cfg))
    got_scores = _recording(ExplainGraph, monkeypatch)
    want_scores = _recording(JExplain, monkeypatch)
    got = main(["-config", str(tmp_path / "explain.yml"), "-mode",
                "graph_explain", "-device", "cpu"])
    assert "Mean AUCROC" in capsys.readouterr().out
    want = JExplain(cfg).eval()
    assert len(want) == len(got) == 2 and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(got_scores, want_scores, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for slide_name in ("test_001", "test_002"):
        png = tmp_path / "plots" / f"{slide_name}.png"
        assert png.exists() and png.with_suffix(".jpeg").exists()
    assert not (tmp_path / "plots" / "normal_001.png").exists()


def test_explain_graph_requires_checkpoint(tmp_path):
    import shutil

    from wsi_hgnn_tpu_torch.explain import ExplainGraph

    cfg = c16_layout(tmp_path, FAMILIES["GCN"], False, slides=("test_009",))
    shutil.rmtree(cfg["checkpoint"]["path"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ExplainGraph(cfg, device="cpu")
