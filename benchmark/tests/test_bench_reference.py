"""The plain reference against the port's plain CPU path at tiny sizes,
and the lower-precision controls against the cells' limits."""
import numpy as np
import pytest
import torch

from bodies import body_arrays
from conftest import load_cell, run_tiny, tiny
import models
import run as bench_run
from reference import cnn, gnn as ref_gnn
from reference import weights as W
from reference.precision import Prec

from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import parse_gnn_model, parse_lattice_twin
from wsi_hgnn_tpu_torch.models.featurizers import (HoVerNet, KimiaNet,
                                                   hovernet_typing_apply)


def shapes(tree):
    return {p: tuple(np.shape(v)) for p, v in W.leaves(tree)}


@pytest.mark.parametrize("cell", ["heat4-train", "hgt-train"])
def test_gnn_spec_is_the_programs_tree(cell):
    _, cfg = load_cell(cell)
    typed, _ = parse_gnn_model(cfg["GNN"])
    twin = parse_lattice_twin(cfg["GNN"]) if cfg["GNN"]["name"] == "HEAT4" else None
    want = shapes(convert.to_flax_variables(twin or typed))
    got = {p: s for p, s, _ in models.gnn_spec(cfg)}
    assert got == want


def test_cnn_specs_are_the_programs_trees():
    assert ({p: s for p, s, _ in W.kimianet_spec()}
            == shapes(convert.to_flax_variables(KimiaNet())))
    assert ({p: s for p, s, _ in W.hovernet_typing_spec()}
            == shapes(convert.to_flax_variables(HoVerNet.typing(6, "fast"))))


@pytest.fixture(scope="module")
def cnn_case():
    _, cfg = bench_run.load_cell("heat4-serve-pixels")
    pool = models.patch_pool(4, 256, 3, "cpu")
    kimia, hover = models.cnn_weights(cfg, 5, "cpu", pool)
    return pool, kimia, hover


def test_cnns_agree_with_the_ports_modules(cnn_case):
    pool, kimia, hover = cnn_case
    px = torch.from_numpy(pool[:2])
    ref_f, ref_v = cnn.featurize(kimia, hover, px, Prec("f32"))
    k = convert.load_flax_variables(KimiaNet(), W.to_numpy(kimia)).eval()
    h = convert.load_flax_variables(HoVerNet.typing(6, "fast"),
                                    W.to_numpy(hover)).eval()
    with torch.no_grad():
        got_f, _ = k(px.float() / 255.0)
        got_t = hovernet_typing_apply(h, px.float() / 255.0, 6)
    assert torch.allclose(got_f, ref_f, rtol=1e-4, atol=1e-5)
    assert torch.equal(got_t.long(), cnn.node_types(ref_v))


def test_fp8_control_fails_the_feature_limit(cnn_case):
    pool, kimia, hover = cnn_case
    px = torch.from_numpy(pool[:2])
    ref_f, _ = cnn.featurize(kimia, hover, px, Prec("f32"))
    c_f, _ = cnn.featurize(kimia, hover, px, Prec("fp8"))
    rel = float(((c_f - ref_f).norm(dim=1) / ref_f.norm(dim=1)).max())
    limit = bench_run.load_cell("heat4-serve-pixels")[0]["limits"]["feat_rel_l2"]
    assert rel > limit


def test_heat4_serving_agrees_and_tf32_fails():
    w, cfg = tiny("heat4-serve-features")
    gw = models.gnn_weights(cfg, 9, "cpu")
    pred = models.predictor(cfg, gw, "cpu")
    f, t = body_arrays(11, 0, 45, 32, 6)
    got = pred.predict_many([(f, t)])[0]
    ft, tt = torch.from_numpy(f), torch.from_numpy(t).long()
    with torch.no_grad():
        g = ref_gnn.tie_variants(ft, tt, 9)[0]
        want = torch.softmax(ref_gnn.heat4_logits(gw, g, cfg["GNN"], Prec("f32")), -1)[0]
        tf = Prec("tf32")
        ctrl = torch.softmax(ref_gnn.heat4_logits(
            gw, ref_gnn.slide_graph(ft, tt, 9, tf), cfg["GNN"], tf), -1)[0]
    limit = w["limits"]["prob_gap"]
    assert float(np.abs(got - want.numpy()).max()) <= limit
    assert float((ctrl - want).abs().max()) > limit


@pytest.mark.parametrize("cell", ["hgt-train", "heat4-train"])
def test_training_agrees_and_tf32_fails(cell):
    out = run_tiny(cell, control=True)
    assert all(v <= lim for v, lim in out.checks.values()), out.checks
    tf32 = {k[5:]: v for k, v in out.control_checks.items() if k.startswith("tf32.")}
    assert any(tf32[k] > lim for k, (_, lim) in out.checks.items()), tf32
