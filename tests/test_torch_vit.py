"""UNI2-h in the port (wsi_hgnn_tpu_torch/models/featurizers/vit.py, the
'uni2-h' encoder, SlidePredictor.enable_pixels, construction) on the CPU,
against the benchmark's plain reference (benchmark/reference/vit.py and
gat.py, imported by path: one reference for the benchmark and the
tests). The JAX package has no UNI2-h.

Small size with every mechanism present: 8 register tokens, no_embed_class,
the packed SwiGLU (fc1 to 256, fc2 from 128), LayerScale, 2 blocks of
width 96 and 4 heads, a 56-pixel input. Tolerance: a relative L2 of 1e-5
a feature row, both in f32: torch's attention and LayerNorm against the
reference's written-out forms sum in another order (4.9e-7 at the
published widths, 24 blocks); every fault here moves a row by over 1e-2.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from wsi_hgnn_tpu_torch.models.featurizers import (ViT, make_cnn_encoder,
                                                   make_vit, vit_apply)
from wsi_hgnn_tpu_torch.models.featurizers import vit as tvit
from wsi_hgnn_tpu_torch.pipeline import construct
from wsi_hgnn_tpu_torch.serve import SlidePredictor
import port_threads  # noqa: F401  (torch threads per test worker)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import models as bench_models  # noqa: E402
from reference import gat as ref_gat  # noqa: E402
from reference import gnn as ref_gnn  # noqa: E402
from reference import vit as ref_vit  # noqa: E402
from reference import weights as W  # noqa: E402
from reference.precision import Prec  # noqa: E402

TINY = dict(img_size=56, patch_size=14, embed_dim=96, depth=2, num_heads=4,
            mlp_hidden=256, reg_tokens=8)
TOL = 1e-5
CPU = torch.device("cpu")
GAT = {"name": "GAT", "negative_slope": 0.2, "num_layers": 2, "in_dim": 96,
       "hidden_dim": 16, "residual": True, "in_drop": 0.2, "attn_drop": 0.2,
       "out_dim": 2, "num_heads": 4, "num_out_heads": 1, "feat_drop": 0.2,
       "graph_pooling_type": "mean"}


HEAT4 = {"name": "HEAT4", "n_node_types": 6, "num_meta_paths": 3,
         "num_layers": 1, "in_dim": 1024, "hidden_dim": 16, "out_dim": 2,
         "n_heads": 2, "num_out_heads": 1, "feat_drop": 0.2,
         "graph_pooling_type": "mean"}
CONSTRUCTION_YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs"
                             / "GraphConstruction").glob("*.yml"))


def rel_l2(got, want):
    got = torch.as_tensor(got, dtype=torch.float32)
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


@pytest.fixture(scope="module")
def case():
    """Seeded reference weights at TINY and 6 structured pool tiles."""
    w = ref_vit.make_weights(ref_vit.spec(TINY), 3, CPU)
    pool = torch.from_numpy(bench_models.patch_pool(6, 256, 4, CPU))
    return w, pool


def port(w, **sizes):
    return make_vit(CPU, state_dict=w, **{**TINY, **sizes})


@pytest.mark.parametrize("tile", [56, 256])
def test_vit_matches_the_reference(case, tile):
    """At 56 pixels the tiles enter as they are; 256-pixel tiles are
    resized (bilinear, antialiased) to 56 first."""
    w, pool = case
    px = pool[:, :tile, :tile] if tile == 56 else pool
    with torch.no_grad():
        got = vit_apply(port(w), px.float() / 255.0)
    want = ref_vit.features(w, px, TINY)
    assert got.dtype == torch.float32 and got.shape == (6, 96)
    assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("fault", ref_vit.FAULTS)
def test_a_faulty_vit_fails_and_matches_the_reference_fault(case, fault,
                                                            monkeypatch):
    """The port with the last block dropped, no register tokens, or SiLU
    on the gate's second half misses the clean reference by far more
    than the tolerance, and equals the reference's own fault (the
    benchmark's controls are the faults they say they are)."""
    w, pool = case
    if fault == "no_registers":
        model = port({**w, "reg_token": w["reg_token"][:, :0]},
                     reg_tokens=0)
    else:
        model = port(w)
    if fault == "skip_last_block":
        model.blocks = model.blocks[:-1]
    if fault == "gate_swapped":
        def swapped(self, x):
            a, b = self.fc1(x).chunk(2, dim=-1)
            return self.fc2(torch.nn.functional.silu(b) * a)
        monkeypatch.setattr(tvit.GluMlp, "forward", swapped)
    with torch.no_grad():
        got = vit_apply(model, pool.float() / 255.0)
    assert rel_l2(got, ref_vit.features(w, pool, TINY)) > 1e3 * TOL
    assert rel_l2(got, ref_vit.features(w, pool, TINY, fault=fault)) <= TOL


def test_published_widths_on_the_meta_device():
    """681,394,176 parameters (the model card's 681M), timm's names and
    shapes (the reference's spec, written from the card's settings), and
    a timm state dict loads strictly."""
    with torch.device("meta"):
        model = ViT()
    assert sum(p.numel() for p in model.parameters()) == 681_394_176
    want = {name: shape for name, shape, _ in ref_vit.spec(ref_vit.UNI2H)}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["reg_token"] == (1, 8, 1536)
    assert got["pos_embed"] == (1, 256, 1536)
    assert got["blocks.0.attn.qkv.weight"] == (4608, 1536)
    assert got["blocks.23.mlp.fc1.weight"] == (8192, 1536)
    assert got["blocks.23.mlp.fc2.weight"] == (1536, 4096)
    assert got["blocks.23.ls2.gamma"] == (1536,)
    model.load_state_dict({k: torch.empty(s, device="meta")
                           for k, s in want.items()}, strict=True, assign=True)
    assert ref_vit.flops_per_patch() == ref_vit.hand_flops_per_patch() \
        == ref_vit.FLOPS_PER_PATCH == 370_940_461_056


def test_weights_from_a_timm_file_or_seeded(case, tmp_path, capsys):
    """A timm-layout file at the configured path loads (and serves the
    same features as the state dict it holds); without one the seeded
    init is timm's (LayerScale at 1e-5), and one line says which ran."""
    w, pool = case
    path = tmp_path / "pytorch_model.bin"
    torch.save({k: v.clone() for k, v in w.items()}, path)
    enc = make_cnn_encoder("uni2-h", {"feature_dim": 96, "vit": TINY,
                                      "uni2h_model_path": str(path)},
                           {}, {}, device=CPU)
    assert f"uni2-h weights: {path}" in capsys.readouterr().out
    feats, types = enc(pool.numpy())
    assert types is None
    assert rel_l2(feats, ref_vit.features(w, pool, TINY)) <= TOL
    seeded = make_vit(CPU, path=str(tmp_path / "absent.bin"), seed=5, **TINY)
    assert "uni2-h weights: seeded init (seed 5)" in capsys.readouterr().out
    assert torch.all(seeded.blocks[1].ls2.gamma == tvit.INIT_VALUES)
    assert float(seeded.blocks[0].attn.qkv.weight.detach().std()) \
        == pytest.approx(0.02, rel=0.1)


def test_uni2h_feature_dim_must_be_its_width(case):
    with pytest.raises(ValueError, match="1024"):
        make_cnn_encoder("uni2-h", {"feature_dim": 1024, "vit": TINY}, {},
                         {}, device=CPU, vit_state_dict=case[0])


def _predictor(gnn, seed=9):
    tree = (ref_gat.spec(gnn) if gnn["name"] == "GAT"
            else bench_models.gnn_spec({"GNN": gnn}))
    gw = W.make_weights(tree, seed, CPU)
    return gw, SlidePredictor({"GNN": dict(gnn)}, radius=9, n_node_types=6,
                              variables=W.to_numpy(gw), device=CPU)


@pytest.mark.parametrize("model", ["GAT", "HEAT4"])
def test_enable_pixels_runs_hovernet_for_heterogeneous_models_only(
        case, model):
    """A homogeneous GAT on UNI2-h gets no HoVer-Net stage, and zero
    types; HEAT4 on KimiaNet still types its patches with HoVer-Net."""
    if model == "GAT":
        _, pred = _predictor(GAT)
        pred.enable_pixels(chunk=4, encoder_name="uni2-h",
                           encoder_config={"vit": TINY},
                           vit_state_dict=case[0])
        assert set(pred._encoder.stages) == {"vit"}
        _, types = pred.featurize(case[1][:3].numpy())
        assert types.tolist() == [0, 0, 0]
    else:
        _, pred = _predictor(HEAT4)
        pred.enable_pixels(chunk=4)
        assert set(pred._encoder.stages) == {"kimianet", "hovernet"}


def test_featurize_launches_a_chunk_before_finishing_the_last(case):
    """serve.featurize launches chunk i + 1 before it finishes chunk i
    (so the host's upload work overlaps the card's), and joins the
    chunks' features in order, equal to the encoder on the whole slide."""
    _, pred = _predictor(GAT)
    pred.enable_pixels(chunk=4, encoder_name="uni2-h",
                       encoder_config={"vit": TINY}, vit_state_dict=case[0])
    enc, calls = pred._encoder, []
    launch, finish = enc.launch, enc.finish

    def logged_launch(px):
        calls.append(f"launch {sum(c != 'finish' for c in calls)}")
        return launch(px)

    def logged_finish(launched):
        calls.append("finish")
        return finish(launched)

    enc.launch, enc.finish = logged_launch, logged_finish
    px = torch.from_numpy(bench_models.patch_pool(11, 256, 7, CPU)).numpy()
    feats, types = pred.featurize(px)
    assert calls == ["launch 0", "launch 1", "finish", "launch 2", "finish",
                     "finish"]
    np.testing.assert_array_equal(feats, np.concatenate(
        [finish(launch(px[i:i + 4]))[0] for i in (0, 4, 8)]))
    assert types.tolist() == [0] * 11


# the stages each encoder name builds for a heterogeneous model
SERVED_STAGES = {"kimia": {"kimianet", "hovernet"},
                 "efficientnet-b4": {"efficientnet", "hovernet"},
                 "hover": {"hovernet"}}


@pytest.mark.parametrize(
    "path,model", [(p, HEAT4) for p in CONSTRUCTION_YAMLS]
    + [(CONSTRUCTION_YAMLS[1], GAT)],
    ids=[p.stem for p in CONSTRUCTION_YAMLS] + ["gat-on-kimia"])
def test_serve_tool_serves_the_encoder_its_construction_yaml_names(
        path, model, monkeypatch):
    """`tools/serve --pixels-config <YAML>` serves the encoder the YAML's
    `graph_constructor.encoder_name` names, the features its graphs were
    built from: KimiaNet or EfficientNet-B4 with HoVer-Net typing beside
    it for a heterogeneous model (KimiaNet alone for the GAT), HoVer-Net's
    fc1 features and types for 'hover'. 'efficientnet-b7', which the port
    does not build, stops the start-up with NotImplementedError. 'hover'
    is only asked for here: its seeded fc1 takes minutes to build on the
    CPU (test_torch_construct_encoders.py builds it from weight files)."""
    from wsi_hgnn_tpu_torch.config import load_config
    from wsi_hgnn_tpu_torch.models import featurizers
    from wsi_hgnn_tpu_torch.tools import serve as tool

    asked = {}
    real = featurizers.make_cnn_encoder

    def spy(name, config, hcfg, kcfg, with_typing=False, **kw):
        asked.update(name=name, with_typing=with_typing)
        if name == "hover":
            return lambda px: None
        return real(name, config, hcfg, kcfg, with_typing=with_typing, **kw)

    monkeypatch.setattr(featurizers, "make_cnn_encoder", spy)
    gcfg = load_config(str(path))
    name = gcfg["graph_constructor"]["encoder_name"]
    _, pred = _predictor(model)
    if name not in SERVED_STAGES:
        with pytest.raises(NotImplementedError, match=name):
            tool.enable_pixels_from(pred, gcfg)
        assert not pred.pixels_enabled
        return
    tool.enable_pixels_from(pred, gcfg)
    hetero = model is HEAT4
    assert asked == {"name": name, "with_typing": hetero}
    if name != "hover":
        want = SERVED_STAGES[name] - ({"hovernet"} if not hetero else set())
        assert set(pred._encoder.stages) == want


def test_gat_on_uni2h_served_from_pixels_matches_the_references(case):
    """Pixels through enable_pixels, featurize (chunks of 4, the last one
    padded) and predict_many (the homogeneous TypedGraph path, self-loops
    added): the features within TOL of the reference ViT, the
    probabilities within 1e-6 of the reference GAT on the served
    features, over every graph an exact f32 KNN may build."""
    w, _ = case
    gw, pred = _predictor(GAT)
    pred.enable_pixels(chunk=4, encoder_name="uni2-h",
                       encoder_config={"vit": TINY}, vit_state_dict=w)
    pool = torch.from_numpy(bench_models.patch_pool(23, 256, 6, CPU))
    for n in (23, 13):
        feats, types = pred.featurize(pool[:n].numpy())
        assert rel_l2(feats, ref_vit.features(w, pool[:n], TINY)) <= TOL
        probs = pred.predict_many([(feats, types)])[0]
        f = torch.from_numpy(feats)
        t = torch.zeros(n, dtype=torch.long)
        with torch.no_grad():
            gap = min(float(np.abs(probs - torch.softmax(ref_gat.logits(
                gw, g, GAT, Prec("f32")), -1)[0].numpy()).max())
                for g in ref_gnn.tie_variants(f, t, 9))
        assert gap <= 1e-6


def test_construction_asks_for_inline_typing_with_uni2h(monkeypatch):
    seen = {}

    def fake(name, config, hcfg, kcfg, with_typing=False, **kw):
        seen[name] = with_typing
        return lambda px: None

    monkeypatch.setattr(construct, "make_encoder", fake)
    for inline in (True, False):
        construct.build_default_encoder(
            {"encoder_name": "uni2-h", "node_type_dir": None,
             "inline_typing": inline}, {}, {}, CPU)
        assert seen["uni2-h"] is inline


def test_construct_all_with_uni2h(case, tmp_path):
    """`construct_all` with `encoder_name: uni2-h` (inline typing off: the
    homogeneous graph is what the GAT reads): every slide's graph holds
    the reference ViT's features of its decoded tiles and the exact KNN
    graph of those features with a self-loop a node."""
    from wsi_hgnn_tpu_torch.data.datasets import load_graph_npz
    from wsi_hgnn_tpu_torch.pipeline.patches import _load_patch_u8, list_patches

    w, _ = case
    pool = bench_models.patch_pool(22, 256, 8, CPU)
    slides = {"TCGA-AA-0001-01Z-00-DX1": pool[:12],
              "TCGA-AA-0002-01Z-00-DX1": pool[12:]}
    for name, tiles in slides.items():
        d = tmp_path / "patches" / "tumor" / name
        d.mkdir(parents=True)
        for i, tile in enumerate(tiles):
            Image.fromarray(tile).save(d / f"{i}_0.jpeg", quality=95)
    gcfg = {"encoder_name": "uni2-h", "feature_dim": 96, "vit": TINY,
            "radius": 9, "n_node_type": 6, "knn_impl": "exact",
            "inline_typing": False, "node_type_dir": None,
            "patch_path": str(tmp_path / "patches") + "/",
            "out_dir": str(tmp_path / "graphs")}
    enc = make_cnn_encoder("uni2-h", gcfg, {}, {}, pad_batch_to=8,
                           device=CPU, vit_state_dict=w)
    with pytest.warns(UserWarning, match="all node types are 0"):
        assert construct.construct_all(gcfg, {"batch_size": 8}, {},
                                       encoder=enc, verbose=False,
                                       device=CPU) == 2
    for name, tiles in slides.items():
        px = torch.from_numpy(np.stack([_load_patch_u8(f) for f in list_patches(
            tmp_path / "patches" / "tumor" / name)]))
        want = ref_vit.features(w, px, TINY)
        g = load_graph_npz(tmp_path / "graphs" / "homogeneous" / f"{name}.npz")
        n = len(tiles)
        feat = np.asarray(g.feat)[:n]
        assert rel_l2(feat, want) <= TOL
        src, dst, _, _ = ref_gnn.slide_edges(torch.from_numpy(feat), 9,
                                             Prec("f32"))
        e = int(np.asarray(g.edge_mask).sum())
        got = set(zip(np.asarray(g.src)[:e].tolist(),
                      np.asarray(g.dst)[:e].tolist()))
        assert got == set(zip(src.tolist(), dst.tolist())) | {
            (i, i) for i in range(n)}
