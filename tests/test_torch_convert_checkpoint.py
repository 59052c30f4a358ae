"""The port's reference-checkpoint converter
(wsi_hgnn_tpu_torch/tools/convert_reference_checkpoint.py) against the
JAX package's tool (tools/convert_reference_checkpoint.py) on the CPU.

* Every round trip of tests/test_convert_checkpoint.py runs with its
  converter replaced by one that converts the same fake reference state
  dict with BOTH tools and requires the trees equal leaf for leaf.
* Every literal fixture of tests/test_convert_fixtures.py (hand-built
  torch-layout state dicts, logits computed in numpy from the torch
  arrays) drives the PORT's model, converted by the port's tool, to the
  numpy logits at that file's tolerance (rtol 5e-4 / atol 1e-5).
* validate_state refuses a config/checkpoint mismatch; `main` writes a
  checkpoint that the port's and the JAX package's predictors serve
  alike.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import port_threads  # noqa: F401  (torch threads per test worker)
import test_convert_checkpoint as tcc
import test_convert_fixtures as tcf

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import convert_reference_checkpoint as jax_tool  # noqa: E402

from wsi_hgnn_tpu_torch import convert  # noqa: E402
from wsi_hgnn_tpu_torch.config import parse_gnn_model  # noqa: E402
from wsi_hgnn_tpu_torch.graph.typed_graph import TypedGraph  # noqa: E402
from wsi_hgnn_tpu_torch.tools import convert_reference_checkpoint as tool  # noqa: E402

ROUND_TRIPS = {
    "heat2": lambda: tcc.test_heat_round_trip("HEAT2"),
    "heat4": lambda: tcc.test_heat_round_trip("HEAT4"),
    "hgt": tcc.test_hgt_round_trip,
    "hetrgcn": tcc.test_hetrgcn_round_trip,
    "gcn": tcc.test_gcn_round_trip_and_unused_params_dropped,
    "gat": tcc.test_gat_round_trip,
    "gin": tcc.test_gin_round_trip_with_batch_stats,
    "ntpool": tcc.test_ntpool_round_trip,
    "gcn_att": tcc.test_gcn_att_pooling_round_trip,
    "gin_att_single_mlp": tcc.test_gin_att_pooling_and_single_mlp_round_trip,
}
FIXTURES = {
    "gcn": tcf.test_gcn_literal_fixture,
    "gat": tcf.test_gat_literal_fixture,
    "gin": tcf.test_gin_literal_fixture,
    "ntpool": tcf.test_ntpool_literal_fixture,
    "hetrgcn": tcf.test_hetrgcn_literal_fixture,
    "hgt": tcf.test_hgt_literal_fixture,
    "heat2": tcf.test_heat2_literal_fixture,
    "heat4": tcf.test_heat4_literal_fixture,
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_converted_trees_equal_the_jax_tool(monkeypatch, case):
    """The JAX round trip (its fake state dict, its exact-equality check
    against the model's own params) with a converter that runs both
    tools and requires their trees equal, dtypes and shapes included."""
    seen = []

    def both(cfg, sd):
        want = jax_tool.convert_gnn_state_dict(cfg, dict(sd))
        got = tool.convert_gnn_state_dict(cfg, dict(sd))
        for col in ("params", "batch_stats"):
            w, g = _flat(want[col]), _flat(got[col])
            assert sorted(g) == sorted(w), col
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        seen.append(cfg["name"])
        return want

    monkeypatch.setattr(tcc, "convert_gnn_state_dict", both)
    ROUND_TRIPS[case]()
    assert seen


def _port_graph(g):
    """The JAX package's host TypedGraph as the port's, on the CPU."""
    return TypedGraph(
        **{k: np.array(getattr(g, k)) for k in (
            "feat", "node_type", "node_graph", "node_mask", "src", "dst",
            "esign", "sim", "edge_mask")},
        n_graphs=g.n_graphs, n_node_types=g.n_node_types,
        n_edge_types=g.n_edge_types).to_torch(torch.device("cpu"))


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_literal_fixture_drives_the_port(monkeypatch, case):
    """The literal fixture's state dict through the port's tool into the
    port's model: its logits equal the numpy reference."""
    ran = []

    def port_apply_and_compare(cfg, sd, g, expect, rtol=5e-4, atol=1e-5):
        variables = tool.convert_gnn_state_dict(cfg, sd)
        model, _ = parse_gnn_model(cfg)
        convert.load_flax_variables(
            model, {c: t for c, t in variables.items() if t})
        with torch.no_grad():
            got = model.eval()(_port_graph(g)).numpy()[0]
        np.testing.assert_allclose(got, expect, rtol=rtol, atol=atol)
        ran.append(cfg["name"])

    monkeypatch.setattr(tcf, "apply_and_compare", port_apply_and_compare)
    FIXTURES[case]()
    assert ran


def _heat_sd(which, seed):
    """A reference-layout state dict of a JAX-initialised HEAT model (the
    JAX test's inverse maps) and the JAX params."""
    cls = tcc.models.HEATNet4 if which == "HEAT4" else tcc.models.HEATNet2
    model = cls(in_dim=tcc.D, hidden_dim=tcc.H, out_dim=2, n_layers=2,
                n_heads=2, n_node_types=tcc.T)
    params = model.init(jax.random.PRNGKey(seed), tcc.graph())["params"]
    sd = {}
    tcc.typed_to_sd(sd, "adapt_ws.{t}", params["adapt_ws"])
    tcc.heat_layers_to_sd(sd, params, 2)
    for i in range(2):
        tcc.lin_to_sd(sd, f"gcs.{i}.e_linear", params[f"gcs_{i}"]["e_linear"])
    tcc.typed_to_sd(sd, "linears_prediction.{t}", params["linears_prediction"])
    if which == "HEAT4":
        for t in range(tcc.T):
            sd[f"attn.{t}.op.weight"] = (
                np.asarray(params[f"attn_{t}"]["op"]["kernel"])[None, :, :])
        for head in ("head_2", "head_1", "head"):
            tcc.lin_to_sd(sd, head, params[head])
    return sd, params


HEAT2_CFG = {"name": "HEAT2", "n_node_types": tcc.T, "num_layers": 2,
             "in_dim": tcc.D, "hidden_dim": tcc.H, "out_dim": 2,
             "n_heads": 2, "feat_drop": 0.0, "graph_pooling_type": "mean"}


def test_validate_state_catches_config_mismatch():
    """A HEAT4 state dict converted with a HEAT2 config parses (HEAT4's
    keys are a superset), and the port's validate_state refuses it with
    a readable diff; the matching config validates and runs a forward."""
    sd, _ = _heat_sd("HEAT4", 10)
    state = tool.convert_gnn_state_dict(HEAT2_CFG, sd)
    with pytest.raises(ValueError, match="shape-mismatch"):
        tool.validate_state(HEAT2_CFG, state)
    heat4 = {**HEAT2_CFG, "name": "HEAT4"}
    tool.validate_state(heat4, tool.convert_gnn_state_dict(heat4, sd))
    del sd["head.bias"]
    with pytest.raises(KeyError):
        tool.convert_gnn_state_dict(heat4, sd)


def test_main_writes_a_checkpoint_both_packages_serve(tmp_path):
    """`python -m ...convert_reference_checkpoint` on a reference
    `model_vN.pt` (a torch state dict written by torch.save) writes a
    flax-msgpack checkpoint: the port's SlidePredictor and the JAX
    package's serve it with equal probabilities (1e-4), and its params
    are the model's own."""
    from wsi_hgnn_tpu.config import loads_config as jax_loads_config
    from wsi_hgnn_tpu.serve import SlidePredictor as JaxPredictor
    from wsi_hgnn_tpu_torch.serve import SlidePredictor

    sd, params = _heat_sd("HEAT2", 4)
    pt = tmp_path / "model_v42.pt"
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in sd.items()}, pt)
    ckpt = tmp_path / "ckpt"
    yml = tmp_path / "heat2.yml"
    yml.write_text(f"""
name: Converted
GNN:
  name: "HEAT2"
  n_node_types: {tcc.T}
  num_layers: 2
  in_dim: {tcc.D}
  hidden_dim: {tcc.H}
  out_dim: 2
  n_heads: 2
  feat_drop: 0.0
  graph_pooling_type: mean
checkpoint:
  path: "{ckpt}"
""")
    tool.main(["-config", str(yml), "--in", str(pt)])
    assert (ckpt / "model_v1.msgpack").exists()

    cfg_j = jax_loads_config(yml.read_text())
    from wsi_hgnn_tpu_torch.config import load_config

    pred = SlidePredictor(load_config(yml), radius=4, n_node_types=tcc.T,
                          device="cpu")
    jpred = JaxPredictor(cfg_j, radius=4, n_node_types=tcc.T)
    rng = np.random.RandomState(5)
    feats = rng.randn(30, tcc.D).astype(np.float32)
    types = rng.randint(0, tcc.T, 30).astype(np.int32)
    got = pred.predict(feats, types)
    want = np.asarray(jpred.predict(feats, types))
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    tcc.assert_trees_equal(jpred.variables["params"], params)
