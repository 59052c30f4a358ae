"""The port on several devices end to end, in one gloo world of 2 CPU
processes: `GNNTrainer` choosing edge sharding for a batch over its
`big_graph_edge_threshold` (tests/test_big_graph.py::
test_trainer_picks_big_graph_mode's cohort and config), and the
multi-device dry run (wsi_hgnn_tpu_torch/parallel/dryrun.py, the
counterpart of __graft_entry__.py::dryrun_multichip) with its census of
the port's collective calls; a world outside big-graph mode says its
ranks duplicate the work, and main.py trains alone under torchrun."""
import numpy as np
import pytest

from test_train_e2e import CFG_TMPL, make_synthetic_cohort

import port_threads  # noqa: F401  (torch threads per test worker)
import port_worlds

WORLD = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cohort")
    train_list, normal_list = make_synthetic_cohort(tmp)
    cfg = tmp / "big.yml"
    cfg.write_text(CFG_TMPL.format(
        train=train_list, normal=normal_list, ckpt=str(tmp / "ckpt_big"),
        gnn="HEAT2", epochs=10))
    cases = [
        ("trainer", port_worlds.trainer_big_graph,
         {"config_path": str(cfg), "other_ckpt": str(tmp / "ckpt_rank1")}),
        ("trainer_small", port_worlds.trainer_mode_message,
         {"config_path": str(cfg), "other_ckpt": str(tmp / "ckpt_small1")}),
        ("dryrun", port_worlds.dryrun, None),
    ]
    return port_worlds.run_world(port_worlds.run_cases, WORLD,
                                 tmp_path_factory.mktemp("world"), cases)


def test_trainer_picks_big_graph_mode(world):
    """With big_graph_edge_threshold 1 in a world of 2 the trainer shards
    the edge store (not the lattice), still fits the synthetic cohort,
    every rank reaches the same stats, and rank 0 alone writes
    checkpoints."""
    r0, r1 = (r["trainer"] for r in world)
    assert r0["big_graph"] and r1["big_graph"]
    assert not r0["lattice"]
    assert r0["stats"]["Training AUC"] > 0.9
    assert np.isfinite(r0["stats"]["Train Loss: "])
    # rank 0's checkpoint writer rounds its stats to 5 decimals in place
    assert sorted(r0["stats"]) == sorted(r1["stats"])
    for k, v in r1["stats"].items():
        assert abs(r0["stats"][k] - v) <= 5e-6, k
    assert r0["versions"] == 10 and r1["versions"] == 0


def test_trainer_outside_big_graph_mode_says_ranks_duplicate(world):
    """A world of 2 whose batches stay under the threshold trains every
    rank on the same batches; rank 0 says so, rank 1 prints nothing."""
    r0, r1 = (r["trainer_small"] for r in world)
    assert not r0["big_graph"] and not r1["big_graph"]
    assert "not in big-graph mode" in r0["printed"]
    assert "duplicate its work" in r0["printed"]
    assert "big-graph mode" not in r1["printed"]


@pytest.mark.parametrize("mode", ["eval", "graph_explain"])
def test_main_refuses_eval_and_explain_under_torchrun(mode, monkeypatch):
    """Under torchrun (WORLD_SIZE > 1) only training joins the world:
    eval and graph_explain raise before any process group or config."""
    from wsi_hgnn_tpu_torch import main

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="runs in one process"):
        main.main(["-mode", mode, "-device", "cpu"])


def test_dryrun_multichip_2(world):
    """Every path of the dry run takes its step with finite losses on both
    ranks; the DP, DP lattice and edge-sharded steps issue only
    all-reduces, the featurizer and sharded construction none."""
    for rank, r in enumerate(world):
        out = r["dryrun"]
        for path in ("dp", "dp_lattice", "big_graph"):
            loss, counts = out[path]
            assert np.isfinite(loss)
            assert counts["all_reduce"] > 0 and counts["broadcast"] == 0
        if rank == 0:
            assert out["featurizer"] == {"all_reduce": 0, "broadcast": 0}
            assert out["construction"] == {"all_reduce": 0, "broadcast": 0}
    # the data-parallel losses are the global batch's: equal on both ranks
    assert world[0]["dryrun"]["dp"][0] == world[1]["dryrun"]["dp"][0]
    assert (world[0]["dryrun"]["big_graph"][0]
            == world[1]["dryrun"]["big_graph"][0])


def test_dryrun_entry_point_runs_a_world_of_2():
    """`python -m wsi_hgnn_tpu_torch.parallel.dryrun 2 --device cpu`
    spawns its own gloo world and prints the summary line."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "wsi_hgnn_tpu_torch.parallel.dryrun", "2",
         "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip(2): dp loss=" in out.stdout
