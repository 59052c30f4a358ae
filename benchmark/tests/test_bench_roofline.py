"""The frozen arithmetic against hand counts."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import roofline
from reference import cnn
from reference import weights as W
from reference.precision import Prec


def test_knn_operations_by_hand():
    assert roofline.knn_ops(2048, 1024) == 4_297_064_448


def test_dense_layer_bytes_by_hand():
    # chunk 128 at H = 64, k_in = 64: reads 64 channels and writes 32
    # (2 bytes each) over 128*64*64 pixels, reads W1 [64, 128] and
    # W2 [128, 288] once
    b, f = roofline.dense_layer_bytes_flops(128, 64, 64)
    assert b == 128 * 64 * 64 * 96 * 2 + (64 * 128 + 128 * 288) * 2
    assert f == 2.0 * 128 * 64 * 64 * (64 * 128 + 9 * 128 * 32)


def test_transition_bytes_by_hand():
    b, f = roofline.transition_bytes_flops(128, 64, 256)
    m = 128 * 32 * 32
    assert b == 128 * 64 * 64 * 256 * 2 + 256 * 128 * 2 + m * 128 * 2 + 8 * 256


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 0.0, "float32") == 1.0
    assert roofline.bound_s(0.0, 67e12, "float32") == 1.0


def test_chunk_bounds_sum_the_layers():
    per_layer = sum(roofline.bound_s(*roofline.dense_layer_bytes_flops(
        128, h, ch + 32 * i), "bfloat16")
        for h, ch, n in roofline.DENSE_BLOCKS for i in range(n))
    assert roofline.dense_layer_chunk_bound_s(128) == pytest.approx(per_layer, rel=1e-12)
    assert sum(n for _, _, n in roofline.DENSE_BLOCKS) == 58


def _meta(spec):
    tree = {}
    for path, shape, _ in spec:
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, device="meta")
    return tree


def test_cnn_operations_counted_on_the_reference():
    px = torch.empty((1, 256, 256, 3), dtype=torch.uint8, device="meta")
    for spec, fn, want in (
            (W.kimianet_spec(), cnn.kimianet_features,
             roofline.KIMIANET_FLOPS_PER_PATCH),
            (W.hovernet_typing_spec(), cnn.hovernet_tp_logits,
             roofline.HOVERNET_TYPING_FLOPS_PER_PATCH)):
        with FlopCounterMode(display=False) as fc:
            fn(_meta(spec), px, Prec("f32"))
        assert fc.get_total_flops() == want


def test_gnn_operations_scale_with_nodes_and_edges():
    gnn = {"in_dim": 1024, "hidden_dim": 512, "num_layers": 2}
    one = roofline.heat4_forward_flops(1000, 8000, gnn)
    assert roofline.heat4_forward_flops(2000, 16000, gnn) == 2 * one
    assert roofline.train_flops("heat4", [(1000, 8000)], gnn) == 3 * one
