"""Inputs and weights are functions of --seed: the same seed gives the
same inputs, any seed the same sizes (in its own order)."""
import copy
import json

import numpy as np
import pytest
import torch

from bodies import body_arrays, body_sizes
from common import Ctx, log_spaced_sizes, sub_seed
from conftest import BENCH
from open_loop import schedule
import models
import run as bench_run

BIG = 2 ** 40 + 12345   # seeds run past 32 bits


def test_sub_seeds_take_large_seeds_and_differ_by_use():
    a, b = sub_seed(BIG, "gnn"), sub_seed(BIG, "cohort")
    assert a != b and 0 <= a < 2 ** 32
    assert sub_seed(BIG, "gnn") == a
    assert sub_seed(BIG + 1, "gnn") != a


def test_weights_repeat_from_the_seed():
    _, cfg = bench_run.load_cell("hgt-train")
    w1 = models.gnn_weights(cfg, BIG, "cpu")
    w2 = models.gnn_weights(cfg, BIG, "cpu")
    w3 = models.gnn_weights(cfg, BIG + 1, "cpu")
    k1 = w1["params"]["gcs_0"]["relation_att"]
    assert torch.equal(k1, w2["params"]["gcs_0"]["relation_att"])
    assert not torch.equal(k1, w3["params"]["gcs_0"]["relation_att"])


def _ctx(cell, seed, tmp_path=None, **params):
    w, c = bench_run.load_cell(cell)
    w = copy.deepcopy(w)
    w["params"].update(params)
    return Ctx(cell, w, c, seed, 1.0, False, torch.device("cpu"), 0.0,
               scratch=tmp_path)


def test_pixel_plan_same_sizes_every_seed():
    drv = bench_run.load_driver("pixels_closed")
    a = drv.plan(_ctx("heat4-serve-pixels", BIG), 4096)
    b = drv.plan(_ctx("heat4-serve-pixels", BIG), 4096)
    c = drv.plan(_ctx("heat4-serve-pixels", BIG + 7), 4096)
    assert a == b and a != c
    assert sorted(n for n, _ in a) == sorted(n for n, _ in c)
    assert all(0 <= off <= 4096 - n for n, off in a + c)


def test_feature_bodies_and_schedule_repeat():
    sizes = body_sizes(1000, 4096, 64)
    assert all(n % 9 == 0 for n in sizes)
    f1, t1 = body_arrays(BIG, 3, 99, 1024, 6)
    f2, t2 = body_arrays(BIG, 3, 99, 1024, 6)
    assert np.array_equal(f1, f2) and np.array_equal(t1, t2)
    d1, b1 = schedule(BIG, 35.0, 20.0, 64)
    d2, b2 = schedule(BIG, 35.0, 20.0, 64)
    d3, b3 = schedule(BIG + 1, 35.0, 20.0, 64)
    assert np.array_equal(d1, d2) and np.array_equal(b1, b2)
    assert not np.array_equal(d1, d3)
    # the same gaps in another order: the same count due, the same mean
    assert abs(len(d1) - len(d3)) <= 3
    assert abs(np.diff(d1).mean() / np.diff(d3).mean() - 1) < 0.05


def test_cohort_repeats_from_the_seed(tmp_path):
    drv = bench_run.load_driver("train_epochs")
    kw = dict(slides=3, min_nodes=20, max_nodes=30)
    out = []
    for i, seed in enumerate((BIG, BIG, BIG + 1)):
        ctx = _ctx("hgt-train", seed, tmp_path / str(i), **kw)
        ctx.config = copy.deepcopy(ctx.config)
        ctx.config["GNN"]["in_dim"] = 16
        paths, labels, ne = drv.write_cohort(ctx, ctx.scratch)
        with np.load(paths[0]) as z:
            out.append((z["feat"].copy(), z["dst"].copy(), labels, ne))
    assert np.array_equal(out[0][0], out[1][0]) and out[0][2] == out[1][2]
    assert not np.array_equal(out[0][0], out[2][0])
    assert sorted(n for n, _ in out[0][3]) == sorted(n for n, _ in out[2][3])


def test_pool_repeats_from_the_seed():
    a = models.patch_pool(3, 64, 11, "cpu")
    b = models.patch_pool(3, 64, 11, "cpu")
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(a, models.patch_pool(3, 64, 12, "cpu"))
