"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and every path of the port on the
card against the CPU path: serving (HTTP too), training and the zoo,
construction and tiling, explanation, the MIL tools, and the sharded
encoders and steps with every rank on the one card.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one, so every process collects the same tests. The module
imports no JAX (the machine with the card has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from wsi_hgnn_tpu_torch import convert, kernels
from wsi_hgnn_tpu_torch.config import (load_config, parse_gnn_model,
                                       parse_lattice_twin, parse_loss,
                                       parse_optimizer)
from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz
from wsi_hgnn_tpu_torch.graph import (batch_graphs, from_arrays,
                                      sort_graph_edges, transforms)
from wsi_hgnn_tpu_torch.graph import ops as gops
from wsi_hgnn_tpu_torch.graph.build import build_batch_device
from wsi_hgnn_tpu_torch.models import DropSource
from wsi_hgnn_tpu_torch.kernels import densenet as kdn
from wsi_hgnn_tpu_torch.kernels import knn as kknn
from wsi_hgnn_tpu_torch.models import lattice as tlat
from wsi_hgnn_tpu_torch.models.featurizers import (KimiaNet, fuse_kimianet,
                                                   kimianet_fused_apply)
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.train import (GNNTrainer, HomoGraphEvaluator,
                                      gradcheck, lattice_train_step,
                                      typed_train_step)
from wsi_hgnn_tpu_torch.utils import set_cuda_numerics
import port_threads  # noqa: F401  (torch threads per test worker)

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[1]

# f32: summation order and the 3xTF32 products' dropped lo*lo terms (about
# 2^-22 of a product; tests/test_torch_densenet.py emulates the split on
# operands single-pass TF32 fails); bf16: outputs carry 8 mantissa bits and
# the bottleneck is rounded to bf16 before the 3x3 conv
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=3e-2)}


def _counts(**launched):
    """Every kernel's launch count: `launched`, the others 0."""
    return {k: launched.get(k, 0) for k in kernels.launch_counts()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_cuda_numerics()
    return torch.device("cuda")


def _exact_features(n, d, seed=0):
    """Small integers with planted duplicate rows (exact ties)."""
    rng = np.random.RandomState(seed)
    f = rng.randint(-8, 9, (n, d)).astype(np.float32)
    f[1::6] = f[0:n - 1:6][: len(f[1::6])]
    return f


@pytest.mark.parametrize("n", [384, 700])
def test_knn_kernel_equals_plain_on_exact_data(cuda, n):
    """Small-integer features make every distance exact in f32, so the
    kernel must equal the plain version bit for bit, planted ties and a
    ragged N (700 is no multiple of the kernel's tiles) included."""
    x = torch.from_numpy(_exact_features(n, 96)).to(cuda)
    mask = torch.arange(n, device=cuda) < n - 50
    before = kknn.knn_l2_fused.launches
    i_k, d_k = kknn.knn_l2_fused(x, 8, mask)
    i_p, d_p = kknn.knn_l2_reference(x, 8, mask)
    torch.cuda.synchronize()
    assert kknn.knn_l2_fused.launches == before + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.parametrize("n,d,k,n_real", [
    # ragged N across the candidate splits and the 128-query tiles
    (700, 96, 8, 650), (3000, 96, 8, 2900), (4100, 64, 8, 4000),
    # D not a multiple of the 8-feature step, or of the 16-byte load
    (1000, 100, 8, 990), (520, 36, 8, 500), (333, 98, 8, 300),
    # k = 1, 16 (the largest with the first-tile bound) and KMAX
    (1024, 96, 1, 1000), (1500, 64, 16, 1400), (1024, 96, kknn.KMAX, 1000),
    (250, 40, kknn.KMAX, 250),
    # a split of one candidate (N = 129: the second split holds row 128)
    (129, 16, 8, 129),
    # fewer live candidates than k: f32-max entries fill in index order
    (384, 96, 8, 5), (300, 64, kknn.KMAX, 20)])
def test_knn_kernel_split_edges_equal_plain(cuda, n, d, k, n_real):
    """Exact data: the split kernel equals the plain version bit for bit
    wherever splits, tiles and feature steps leave ragged edges."""
    x = torch.from_numpy(_exact_features(n, d)).to(cuda)
    mask = torch.arange(n, device=cuda) < n_real
    before = kknn.knn_l2_fused.launches
    i_k, d_k = kknn.knn_l2_fused(x, k, mask)
    i_p, d_p = kknn.knn_l2_reference(x, k, mask)
    torch.cuda.synchronize()
    assert kknn.knn_l2_fused.launches == before + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.parametrize("n,k", [(2048, 8), (1100, kknn.KMAX)])
def test_knn_kernel_all_rows_equal_keeps_index_order(cuda, n, k):
    """Every distance ties: whatever order threads and splits arrive in,
    each query's neighbours are the lowest live indices but its own."""
    x = torch.from_numpy(np.tile(_exact_features(1, 64), (n, 1))).to(cuda)
    mask = torch.arange(n, device=cuda) < n - 30
    i_k, d_k = kknn.knn_l2_fused(x, k, mask)
    i_p, d_p = kknn.knn_l2_reference(x, k, mask)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
    assert not d_k.any()
    first = torch.arange(k + 1, device=cuda, dtype=torch.int32)
    assert torch.equal(i_k[k + 1], first[:k])       # a query past the first k
    assert torch.equal(i_k[0], first[1:])            # query 0 skips itself


def test_knn_kernel_large_slide_equals_tiled(cuda):
    """N = 8192: against the streaming plain version (no [N, N] matrix)."""
    from wsi_hgnn_tpu_torch.ops.knn import knn_l2_tiled

    n = 8192
    x = torch.from_numpy(_exact_features(n, 64, seed=1)).to(cuda)
    mask = torch.arange(n, device=cuda) < n - 100
    before = kknn.knn_l2_fused.launches
    i_k, d_k = kknn.knn_l2_fused(x, 8, mask)
    i_p, d_p = knn_l2_tiled(x, 8, mask)
    torch.cuda.synchronize()
    assert kknn.knn_l2_fused.launches == before + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.parametrize("impl", ["exact", "approx", "pallas"])
def test_knn_lookup_every_impl_launches_the_kernel(cuda, impl):
    """'approx' on the card is the kernel too (exact neighbours), and so
    are build_edges_device and knn_edges, which a user calls directly."""
    from wsi_hgnn_tpu_torch.graph import build_edges_device
    from wsi_hgnn_tpu_torch.ops.knn import knn_edges, knn_lookup

    n = 1000
    x = torch.from_numpy(_exact_features(n, 64, seed=2))
    mask = torch.arange(n) < n - 30
    i_p, d_p = kknn.knn_l2_reference(x, 8, mask)
    before = kknn.knn_l2_fused.launches
    i_k, d_k = knn_lookup(x.to(cuda), 8, mask.to(cuda), impl=impl)
    e_k = build_edges_device(x.to(cuda), 9, mask.to(cuda), knn_impl=impl)
    s_k, t_k = knn_edges(x.to(cuda), 8, mask.to(cuda))
    torch.cuda.synchronize()
    assert kknn.knn_l2_fused.launches == before + 3
    assert torch.equal(i_k.cpu(), i_p) and torch.equal(d_k.cpu(), d_p)
    e_p = build_edges_device(x, 9, mask, knn_impl=impl)
    for i in (0, 1, 4):                  # src, dst, edge_mask
        assert torch.equal(e_k[i].cpu(), e_p[i])
    assert torch.allclose(e_k[3].cpu(), e_p[3], atol=1e-5)
    clear = e_p[3].abs() > 1e-5          # esign = sim > 0, where sim clears
    assert torch.equal(e_k[2].cpu()[clear], e_p[2][clear])
    assert torch.equal(t_k.cpu(), i_p.reshape(-1))
    assert torch.equal(s_k.cpu(), torch.arange(n, dtype=torch.int32
                                               ).repeat_interleave(8))


def test_knn_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(64, 8, device=cuda)
    with pytest.raises(ValueError):
        kknn.knn_l2_fused(x, kknn.KMAX + 1)
    with pytest.raises(ValueError):
        kknn.knn_l2_fused(x, 4, torch.ones(63, dtype=torch.bool, device=cuda))


def _layer(dev, dtype, h=16, c_end=256, k_in=160, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.zeros(b, h, h, c_end)
    x[..., :k_in] = torch.randn(b, h, h, k_in, generator=g)
    a1, b1 = torch.zeros(1, c_end), torch.zeros(1, c_end)
    a1[0, :k_in] = torch.rand(k_in, generator=g) + 0.5
    b1[0, :k_in] = torch.randn(k_in, generator=g) * 0.1
    w1f = torch.zeros(c_end, 128)
    w1f[:k_in] = torch.randn(k_in, 128, generator=g) * (2.0 / k_in) ** 0.5
    b2 = torch.randn(1, 128, generator=g) * 0.1
    w2cat = torch.randn(128, 288, generator=g) * (2.0 / 1152) ** 0.5
    return (x.to(dev, dtype), a1.to(dev), b1.to(dev), w1f.to(dev, dtype),
            b2.to(dev), w2cat.to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k_in,c_end", [
    (16, 160, 256), (12, 64, 256), (8, 224, 256),
    # the main path's blocks, first and last layer
    (64, 64, 256), (64, 224, 256), (32, 128, 512), (32, 480, 512),
    (16, 256, 1024), (16, 992, 1024), (8, 512, 1024), (8, 992, 1024),
    # ragged 16x16 tiles; k_in ending in a half 64-channel chunk
    (20, 96, 256), (12, 224, 256)])
def test_dense_layer_kernel_matches_plain(cuda, dtype, h, k_in, c_end):
    """In place: the prefix is untouched, the slot matches the plain
    version, the channels past the slot stay 0. H=12 leaves a ragged
    8x8 output tile in the f32 kernel; H=20 ragged 16x16 tiles in the
    bf16 one."""
    ops = _layer(cuda, dtype, h=h, c_end=c_end, k_in=k_in)
    kw = dict(n_active_groups=-(-k_in // 128), slot=k_in // 32)
    got = kdn.dense_layer_fused(ops[0].clone(), *ops[1:], **kw)
    want = kdn.dense_layer_reference(ops[0].clone(), *ops[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[..., :k_in], ops[0][..., :k_in])
    assert not got[..., k_in + 32:].any()
    torch.testing.assert_close(got[..., k_in:k_in + 32].float(),
                               want[..., k_in:k_in + 32].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,bsz", [
    (8, 64, 3), (16, 256, 3), (6, 320, 3),
    # the main path's three transitions
    (64, 256, 2), (32, 512, 2), (16, 1024, 2)])
def test_transition_kernel_matches_plain(cuda, dtype, h, c, bsz):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(bsz, h, h, c, generator=g).to(cuda, dtype)
    a = (torch.rand(1, c, generator=g) + 0.5).to(cuda)
    b = (torch.randn(1, c, generator=g) * 0.1).to(cuda)
    w = (torch.randn(c, c // 2, generator=g) * (2.0 / c) ** 0.5).to(cuda, dtype)
    torch.testing.assert_close(kdn.transition_fused(x, a, b, w).float(),
                               kdn.transition_reference(x, a, b, w).float(),
                               **TOL[dtype])
    out = torch.zeros(bsz, h // 2, h // 2, c // 2 + 32, dtype=dtype,
                      device=cuda)
    kdn.transition_fused(x, a, b, w, out=out)
    torch.testing.assert_close(out[..., :c // 2].float(),
                               kdn.transition_reference(x, a, b, w).float(),
                               **TOL[dtype])
    assert not out[..., c // 2:].any()


@pytest.mark.parametrize("h,w,k_in,c_end,b", [
    # C_end % 4 != 0: 4-byte copies and stores
    (16, 16, 192, 226, 2), (8, 8, 64, 97, 3),
    # non-square images: ragged 16x8 tiles in each direction
    (20, 13, 96, 160, 2), (5, 11, 32, 64, 3)])
def test_dense_layer_f32_ragged_matches_plain(cuda, h, w, k_in, c_end, b):
    """The f32 kernel on shapes the main path does not give it: rows
    that are not 16-byte multiples, and images whose sides cut its 16x8
    output tiles (and the whole-image tile below 8) raggedly."""
    ops = list(_layer(cuda, torch.float32, h=h, c_end=c_end, k_in=k_in, b=b))
    g = torch.Generator().manual_seed(3)
    ops[0] = torch.zeros(b, h, w, c_end)
    ops[0][..., :k_in] = torch.randn(b, h, w, k_in, generator=g)
    ops[0] = ops[0].to(cuda)
    kw = dict(n_active_groups=-(-k_in // 128), slot=k_in // 32)
    got = kdn.dense_layer_fused(ops[0].clone(), *ops[1:], **kw)
    want = kdn.dense_layer_reference(ops[0].clone(), *ops[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[..., :k_in], ops[0][..., :k_in])
    assert not got[..., k_in + 32:].any()
    torch.testing.assert_close(got[..., k_in:k_in + 32],
                               want[..., k_in:k_in + 32],
                               **TOL[torch.float32])


@pytest.mark.parametrize("h,w,c,bsz", [
    # C % 8 != 0 (4-byte copies), C/2 odd, C not a multiple of the
    # 16-channel chunk
    (8, 8, 36, 3), (6, 6, 50, 2), (8, 8, 40, 2),
    # odd and non-square sides (the last row/column is dropped), and a
    # batch tail across the 128-pixel tiles
    (7, 9, 64, 3), (10, 14, 96, 5)])
def test_transition_f32_ragged_matches_plain(cuda, h, w, c, bsz):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(bsz, h, w, c, generator=g).to(cuda)
    a = (torch.rand(1, c, generator=g) + 0.5).to(cuda)
    b = (torch.randn(1, c, generator=g) * 0.1).to(cuda)
    wt = (torch.randn(c, c // 2, generator=g) * (2.0 / c) ** 0.5).to(cuda)
    want = kdn.transition_reference(x, a, b, wt)
    torch.testing.assert_close(kdn.transition_fused(x, a, b, wt), want,
                               **TOL[torch.float32])
    out = torch.zeros(bsz, h // 2, w // 2, c // 2 + 3, device=cuda)
    kdn.transition_fused(x, a, b, wt, out=out)
    torch.testing.assert_close(out[..., :c // 2], want, **TOL[torch.float32])
    assert not out[..., c // 2:].any()


@pytest.mark.parametrize("h,k_in,c_end", [
    # the last layer of each dense block
    (64, 224, 256), (32, 480, 512), (16, 992, 1024), (8, 992, 1024)])
def test_dense_layer_f32_at_simclr_batch_matches_plain(cuda, h, k_in, c_end):
    """B = 128, SimCLR's backbone batch: every output tile and image of a
    launch the main path makes."""
    ops = _layer(cuda, torch.float32, h=h, c_end=c_end, k_in=k_in, b=128)
    kw = dict(n_active_groups=-(-k_in // 128), slot=k_in // 32)
    got = kdn.dense_layer_fused(ops[0].clone(), *ops[1:], **kw)
    want = kdn.dense_layer_reference(ops[0].clone(), *ops[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[..., :k_in], ops[0][..., :k_in])
    assert not got[..., k_in + 32:].any()
    torch.testing.assert_close(got[..., k_in:k_in + 32],
                               want[..., k_in:k_in + 32],
                               **TOL[torch.float32])


@pytest.mark.parametrize("h,c", [(64, 256), (32, 512), (16, 1024)])
def test_transition_f32_at_simclr_batch_matches_plain(cuda, h, c):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(128, h, h, c, generator=g, device=cuda)
    a = torch.rand(1, c, generator=g, device=cuda) + 0.5
    b = torch.randn(1, c, generator=g, device=cuda) * 0.1
    wt = torch.randn(c, c // 2, generator=g, device=cuda) * (2.0 / c) ** 0.5
    torch.testing.assert_close(kdn.transition_fused(x, a, b, wt),
                               kdn.transition_reference(x, a, b, wt),
                               **TOL[torch.float32])


def _planted(rng, shape, scale=1.0, signed=True):
    """+-(1 + j 2^-13), j in [1, 64): mantissa bits below TF32's 10 (see
    tests/test_torch_densenet.py's emulation of the split on them)."""
    j = rng.randint(1, 64, size=shape)
    sign = rng.choice([-1.0, 1.0], size=shape) if signed else 1.0
    return torch.from_numpy(
        (sign * (1.0 + j * 2.0 ** -13) * scale).astype(np.float32))


def _misses(got, want, tol):
    return ((got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()).any()


def _plain_in_tf32(fn):
    """fn() with torch's f32 products and convolutions in TF32, the flags
    restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_dense_layer_f32_planted_operands_need_3xtf32(cuda):
    """x and weights carry mantissa bits below TF32's, at the main path's
    largest K (k_in 992 into the 1x1 conv, 9 x 128 into the 3x3): the
    kernel stays within the f32 tolerance; torch's own products in TF32
    on the same operands fall outside it."""
    h, k_in, c_end, b = 8, 992, 1024, 4
    rng = np.random.RandomState(6)
    x = torch.zeros(b, h, h, c_end)
    x[..., :k_in] = _planted(rng, (b, h, h, k_in), signed=False)
    a1 = torch.zeros(1, c_end)
    a1[0, :k_in] = 1.0                              # u = x exactly
    b1 = torch.zeros(1, c_end)
    w1f = torch.zeros(c_end, 128)
    w1f[:k_in] = _planted(rng, (k_in, 128), (2.0 / k_in) ** 0.5)
    b2 = torch.from_numpy(rng.randn(1, 128).astype(np.float32) * 0.1)
    w2cat = _planted(rng, (128, 288), (2.0 / 1152) ** 0.5)
    ops = [t.to(cuda) for t in (x, a1, b1, w1f, b2, w2cat)]
    kw = dict(n_active_groups=8, slot=k_in // 32)
    got = kdn.dense_layer_fused(ops[0].clone(), *ops[1:], **kw)
    want = kdn.dense_layer_reference(ops[0].clone(), *ops[1:], **kw)
    tf32 = _plain_in_tf32(lambda: kdn.dense_layer_reference(
        ops[0].clone(), *ops[1:], **kw))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    sl = slice(k_in, k_in + 32)
    torch.testing.assert_close(got[..., sl], want[..., sl],
                               **TOL[torch.float32])
    assert _misses(tf32[..., sl], want[..., sl], TOL[torch.float32])


def test_transition_f32_planted_operands_need_3xtf32(cuda):
    """The same at the last transition's C = 1024 (a = 1, b = 0, so the
    pooled u keeps the planted bits): the kernel within the f32
    tolerance, torch's TF32 product outside it."""
    h, c, bsz = 16, 1024, 2
    rng = np.random.RandomState(7)
    x = _planted(rng, (bsz, h, h, c), signed=False).to(cuda)
    a = torch.ones(1, c, device=cuda)
    b = torch.zeros(1, c, device=cuda)
    wt = _planted(rng, (c, c // 2), (2.0 / c) ** 0.5).to(cuda)
    got = kdn.transition_fused(x, a, b, wt)
    want = kdn.transition_reference(x, a, b, wt)
    tf32 = _plain_in_tf32(lambda: kdn.transition_reference(x, a, b, wt))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert _misses(tf32, want, TOL[torch.float32])


@pytest.mark.parametrize("name", ["dense_layer", "transition"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densenet_kernels_fit_an_sm(cuda, name, dtype):
    """At least one block per SM, within the H100's 227 KB a block."""
    blocks, smem = kdn.occupancy(name, dtype)
    assert blocks >= 1 and 0 < smem <= 232448


def test_kernel_wrappers_raise_instead_of_falling_back(cuda):
    ops = list(_layer(cuda, torch.float32))
    ops[3] = ops[3].to(torch.bfloat16)  # weights in another dtype
    with pytest.raises(ValueError):
        kdn.dense_layer_fused(*ops, n_active_groups=2, slot=5)
    x = torch.randn(2, 8, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        kdn.transition_fused(x.transpose(1, 2), torch.ones(1, 64, device=cuda),
                             torch.zeros(1, 64, device=cuda),
                             torch.zeros(64, 32, device=cuda))
    x = torch.randn(2, 8, 8, 48, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # the bf16 kernel takes 32-channel chunks
        kdn.transition_fused(x, torch.ones(1, 48, device=cuda),
                             torch.zeros(1, 48, device=cuda),
                             torch.zeros(48, 24, device=cuda,
                                         dtype=torch.bfloat16))


def test_fused_kimianet_on_card_matches_module(cuda):
    """The kernel chain in f32 storage against the unfused module, both on
    the card (TF32 off), at the CPU parity test's 256x256 tolerance."""
    model = convert.init_flax_like_(KimiaNet(), seed=0).eval()
    fp = fuse_kimianet(convert.to_flax_variables(model), dtype=torch.float32,
                       device=cuda)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got, _ = kimianet_fused_apply(fp, x.to(cuda))
        want, _ = model.to(cuda)(x.to(cuda))
    counts = kernels.launch_counts()
    assert counts["dense_layer_fused"] == 58
    assert counts["transition_fused"] == 3
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_slide_predictor_on_card_matches_cpu(cuda):
    gnn = {"name": "HEAT4", "n_node_types": 6, "num_layers": 2, "in_dim": 64,
           "hidden_dim": 32, "out_dim": 2, "n_heads": 2, "feat_drop": 0.0,
           "graph_pooling_type": "mean"}
    variables = convert.to_flax_variables(
        convert.init_flax_like_(parse_lattice_twin(gnn), seed=0))
    rng = np.random.RandomState(3)
    slides = [(rng.randn(n, 64).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32)) for n in (300, 41)]
    on_card = SlidePredictor({"GNN": gnn}, variables=variables, device=cuda)
    on_cpu = SlidePredictor({"GNN": gnn}, variables=variables, device="cpu")
    before = kknn.knn_l2_fused.launches
    got = on_card.predict_many(slides)
    assert kknn.knn_l2_fused.launches == before + 2  # one KNN per slide
    np.testing.assert_allclose(got, on_cpu.predict_many(slides), atol=1e-4)


SMALL_GNN = {"name": "HEAT4", "n_node_types": 6, "num_layers": 2,
             "in_dim": 32, "hidden_dim": 16, "out_dim": 2, "n_heads": 2,
             "feat_drop": 0.2, "graph_pooling_type": "mean"}


def test_typed_linear_ragged_on_card_matches_onehot(cuda):
    """Forward and backward of the grouped per-type product on the card
    against the one-hot form (type 5 has no rows)."""
    rng = np.random.RandomState(7)
    arrays = (rng.randn(3000, 64), rng.randn(6, 64, 48), rng.randn(6, 48))
    types = torch.from_numpy(rng.randint(0, 5, 3000)).to(cuda)
    out = []
    for fn in (gops.typed_linear, gops.typed_linear_ragged):
        feat, w, b = (torch.tensor(a, dtype=torch.float32, device=cuda,
                                   requires_grad=True) for a in arrays)
        y = fn(feat, types, w, b)
        (y * torch.linspace(-1, 1, y.numel(), device=cuda).reshape(y.shape)
         ).sum().backward()
        out.append((y.detach(), feat.grad, w.grad, b.grad))
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not out[1][2][5].any()


def judge_grads(named_cpu, named_dev, run64, base64, dev, plant=None):
    """gradcheck.judge on the `.grad` of one step on the CPU and on the
    card, as chip_smoke.py judges it (wsi_hgnn_tpu_torch/train/
    gradcheck.py): within GRAD_RTOL, or the card's float64 step equal to
    the CPU's and its f32 within the f32 rounding of randomly rounded
    float64 steps; a gradient exactly zero in float64 and in every draw
    (a dead layer) exactly zero on the card. `run64(model, device)` runs
    the float64 step in place; `base64` is the float64 model before it;
    `plant(model)`, where given, alters the card's float64 model as the
    card's f32 one was altered. Returns (the judge's text, the names it
    fails, the float64 gradients {'cpu': ..., 'card': ... or absent})."""
    m64 = copy.deepcopy(base64)
    run64(m64, torch.device("cpu"))
    g64 = {n: p.grad.detach().double() for n, p in m64.named_parameters()
           if p.requires_grad}
    seen = {"cpu": g64}

    def card64():
        m = copy.deepcopy(base64).to(dev)
        if plant is not None:
            plant(m)
        run64(m, dev)
        seen["card"] = {n: p.grad.detach().cpu().double()
                        for n, p in m.named_parameters() if p.requires_grad}
        return m.named_parameters()

    text, failed = gradcheck.judge(
        named_cpu, named_dev, m64.named_parameters(),
        lambda: gradcheck.rounding_spread(lambda m: run64(m, dev), base64,
                                          g64, device=dev), card64)
    return text, failed, seen


def assert_grads_match(named_cpu, named_dev, run64, base64, dev):
    """judge_grads, which must fail no tensor."""
    text, failed, _ = judge_grads(named_cpu, named_dev, run64, base64, dev)
    assert not failed, (failed, text)


def _lattice_step_judged(cuda, gnn, g_cpu):
    """One lattice Adam step of `gnn`'s HEAT4 from seed 0's init on the
    batch `g_cpu` (labels 0, 1), on the CPU and on the card, with the
    augmentation and dropout masks drawn once. Returns ((loss, prob,
    model) on the CPU, the same on the card, judge_grads' text and
    failed names)."""
    model = convert.init_flax_like_(parse_lattice_twin(gnn), seed=0)
    gen = torch.Generator().manual_seed(1)
    masks = tlat.draw_train_masks(g_cpu, gen)
    drops = model.draw_dropout_masks(g_cpu, gen)
    optim = {"opt_method": "ADAM", "lr": 1e-3, "weight_decay": 5e-3}
    loss_fn = parse_loss({"loss": "CE"})
    labels, weights = torch.tensor([0, 1]), torch.tensor([1.0, 1.0])
    res = []
    base64 = convert.init_flax_like_(parse_lattice_twin(gnn), seed=0)
    base64.double()

    def run64(m, dev):
        with gradcheck.float64_default():
            lattice_train_step(
                m, parse_optimizer(optim, m.parameters()), loss_fn,
                tlat.LatticeGraph(*(a.to(dev) for a in g_cpu._replace(
                    feats=g_cpu.feats.double(), sim=g_cpu.sim.double()))),
                labels.to(dev), weights.double().to(dev),
                masks=tlat.TrainMasks(*(a.to(dev) for a in masks)),
                drop_masks=[a.to(dev) for a in drops])

    for dev, m in ((torch.device("cpu"), model),
                   (cuda, convert.init_flax_like_(
                       parse_lattice_twin(gnn), seed=0).to(cuda))):
        loss, prob = lattice_train_step(
            m, parse_optimizer(optim, m.parameters()), loss_fn,
            tlat.LatticeGraph(*(a.to(dev) for a in g_cpu)), labels.to(dev),
            weights.to(dev), masks=tlat.TrainMasks(*(a.to(dev) for a in masks)),
            drop_masks=[a.to(dev) for a in drops])
        res.append((float(loss), prob.cpu(), m))
    text, failed, _ = judge_grads(res[0][2].named_parameters(),
                                  res[1][2].named_parameters(), run64, base64,
                                  cuda)
    return (*res, text, failed)


def test_train_step_on_card_matches_cpu(cuda):
    """One Adam step from the same weights, batch, augmentation and dropout
    masks: loss to 1e-5 relative, and every parameter's gradient to 1e-4
    relative L2 (the gradients the step leaves in `.grad`; see
    assert_grads_match)."""
    rng = np.random.RandomState(4)
    b, n = 2, 400
    g_cpu = tlat.build_lattice_device(
        torch.from_numpy(rng.randn(b, n, 32).astype(np.float32)),
        torch.from_numpy(rng.randint(0, 6, (b, n))),
        torch.arange(n)[None, :] < torch.tensor([[n], [n - 37]]), 9, 6)
    (l_cpu, p_cpu, _), (l_dev, p_dev, _), text, failed = \
        _lattice_step_judged(cuda, SMALL_GNN, g_cpu)
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    torch.testing.assert_close(p_dev, p_cpu, rtol=1e-5, atol=1e-6)
    assert not failed, (failed, text)


def test_lattice_train_step_on_card_matches_cpu_at_brca_width(cuda):
    """The lattice step of configs/BRCA/HEAT4_kimia_classification.yml's
    HEAT4 (in 1024, hidden 512, 4 heads) on two seeded slides of 800-1600
    nodes: loss to 1e-5 relative, gradients by the float64 judge."""
    rng = np.random.RandomState(4)
    sizes = rng.randint(800, 1601, 2)
    n = int(sizes.max())
    g_cpu = tlat.build_lattice_device(
        torch.from_numpy((rng.randn(2, n, 1024) + 0.5 * np.arange(2)[
            :, None, None]).astype(np.float32)),
        torch.from_numpy(rng.randint(0, 6, (2, n))),
        torch.arange(n)[None, :] < torch.from_numpy(sizes)[:, None], 9, 6)
    (l_cpu, _, _), (l_dev, _, _), text, failed = _lattice_step_judged(
        cuda, load_config(BRCA["HEAT4"][0])["GNN"], g_cpu)
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    assert not failed, (failed, text)


# every zoo family at its BRCA classification config's widths (in_dim
# 1024), as GNNTrainer trains it: (config, train overrides); HEAT4 on the
# lattice, and HEAT4 with the lattice off on the TypedGraph path
BRCA = {name: (ROOT / f"configs/BRCA/{stem}.yml", train)
        for name, stem, train in (
            ("GCN", "GCN_kimia_classification", {}),
            ("GAT", "GAT_kimia_classification", {}),
            ("GIN", "GIN_kimia_classification", {}),
            ("GCN_NTPool", "GCN_NTPool_kimia_classification", {}),
            ("HetRGCN", "HetRGCN_kimia_classification", {}),
            ("HGT", "HGT_kimia_classification", {}),
            ("GCN_asap", "GCN_asap_classification", {}),
            ("HEAT4", "HEAT4_kimia_classification", {}),
            ("HEAT4_typed", "HEAT4_kimia_classification",
             {"lattice": "off"}))}
COHORT = (("train", 6), ("val", 3), ("test", 3))   # slides per split


def _write_cohort(cuda, root, in_dim, hetero, seed=2):
    """12 seeded slides of 800-1600 patches (tumour slides, odd index,
    shifted by +0.5) under TCGA barcodes, each graph built on the card by
    one KNN launch, split 6/3/3; untyped files (self-loops added at load)
    for homogeneous models. Returns {split: list file}."""
    rng = np.random.RandomState(seed)
    splits, normals, i = {}, [], 0
    for split, count in COHORT:
        paths = []
        for _ in range(count):
            n = int(rng.randint(800, 1601))
            feat = (rng.randn(n, in_dim) + 0.5 * (i % 2)).astype(np.float32)
            types = rng.randint(0, 6, n).astype(np.int32)
            before = kknn.knn_l2_fused.launches
            g = tlat.build_lattice_device(
                torch.from_numpy(feat[None]).to(cuda),
                torch.from_numpy(types[None]).to(cuda),
                torch.ones(1, n, dtype=torch.bool, device=cuda), 9, 6)
            assert kknn.knn_l2_fused.launches == before + 1
            barcode = f"TCGA-XX-{i:04d}-01Z-00-DX1"
            paths.append(str(root / f"{barcode}.npz"))
            save_graph_npz(paths[-1], feat, np.repeat(np.arange(n), 8),
                           g.idx[0].reshape(-1).cpu().numpy(),
                           node_type=types,
                           esign=g.esign[0].reshape(-1).cpu().numpy(),
                           sim=g.sim[0].reshape(-1).cpu().numpy(),
                           is_hetero=hetero)
            if i % 2 == 0:
                normals.append(barcode[:16])
            i += 1
        splits[split] = root / f"{split}.txt"
        splits[split].write_text("\n".join(paths) + "\n")
    (root / "normal.txt").write_text("\n".join(normals) + "\n")
    return splits


@pytest.mark.parametrize("family", sorted(BRCA))
def test_trainer_one_epoch_on_card(cuda, tmp_path, family):
    """The whole trainer for one epoch, at the family's BRCA config's
    widths and batch size, on 12 slides of 800-1600 x 1024 whose graphs
    were built on the card (HEAT4 on the lattice; the other families, and
    HEAT4 with the lattice off, on the TypedGraph path): a finite loss a
    step; the evaluator on its checkpoint, on the card and on the CPU,
    equal to the trainer's last test metrics over a test split of both
    classes; and SlidePredictor(checkpoint_path=) on the card, each
    graph rebuilt from the slide's features by one KNN launch and no
    other kernel, equal to the evaluator."""
    path, train = BRCA[family]
    cfg = load_config(path)
    splits = _write_cohort(cuda, tmp_path, int(cfg["GNN"]["in_dim"]),
                           parse_gnn_model(cfg["GNN"])[1])
    cfg["datasets"].update(
        train_path=str(splits["train"]), valid_path=str(splits["val"]),
        eval_path=str(splits["test"]),
        normal_path=str(tmp_path / "normal.txt"))
    cfg["checkpoint"]["path"] = str(tmp_path / "ckpt")
    cfg["train"].update(train, num_epochs=1)
    trainer = GNNTrainer(cfg, seed=0, device=cuda)
    losses, step = [], trainer.train_step

    def recorded(*batch):
        out = step(*batch)
        losses.append(float(out[0]))
        return out

    trainer.train_step = recorded
    stats = trainer.train()
    assert trainer.lattice == (family == "HEAT4")
    assert len(losses) == -(-6 // int(cfg["train"]["batch_size"]))
    assert np.isfinite(losses).all()
    assert stats["Epoch"] == 1 and np.isfinite(stats["Train Loss: "])
    assert (tmp_path / "ckpt" / "model_v1.msgpack").exists()
    on_card = HomoGraphEvaluator(cfg, verbose=False, device=cuda)
    on_cpu = HomoGraphEvaluator(cfg, verbose=False, device="cpu")
    got = on_card.eval()
    np.testing.assert_allclose(got, on_cpu.eval(), atol=1e-6)
    np.testing.assert_allclose(got, [stats[f"Testing {m}"] for m in (
        "Accuracy", "F1", "Precision", "Recall", "AUC")], atol=1e-5)
    assert on_card.splits.loader_of(on_card.test_data)[0] == (
        "lattice" if family == "HEAT4" else "typed")
    assert set(on_card.last_metrics["label"].tolist()) == {0, 1}
    np.testing.assert_allclose(on_card.last_metrics["prob"],
                               on_cpu.last_metrics["prob"], atol=1e-4)
    pred = SlidePredictor(cfg, checkpoint_path=str(tmp_path / "ckpt"),
                          device=cuda)
    served = []
    kernels.reset_launch_counts()
    for path in on_card.test_data.graph_paths:
        with np.load(path) as z:
            served.append(pred.predict(z["feat"], z["node_type"]))
    assert kernels.launch_counts() == _counts(knn_l2_fused=3)
    np.testing.assert_allclose(np.stack(served), on_card.last_metrics["prob"],
                               atol=1e-4)


# one small GNN section per zoo family (widths 32, 2 layers, 2 heads)
_ZOO_BASE = {"in_dim": 32, "hidden_dim": 32, "out_dim": 2, "num_layers": 2,
             "n_node_types": 6, "feat_drop": 0.2}
ZOO = {
    "GCN": dict(_ZOO_BASE, name="GCN", graph_pooling_type="att"),
    "GAT": dict(_ZOO_BASE, name="GAT", num_heads=2, num_out_heads=1,
                attn_drop=0.2, negative_slope=0.2, graph_pooling_type="mean"),
    "GIN": dict(_ZOO_BASE, name="GIN", num_layers=3, num_mlp_layers=2,
                graph_pooling_type="att", neighbor_pooling_type="mean"),
    "GCN_NTPool": dict(_ZOO_BASE, name="GCN_NTPool",
                       graph_pooling_type="mean"),
    "HetRGCN": dict(_ZOO_BASE, name="HetRGCN", graph_pooling_type="mean",
                    edge_types=["pos", "neg"]),
    "HGT": dict(_ZOO_BASE, name="HGT", num_heads=2, graph_pooling_type="mean"),
    "HEAT4": dict(_ZOO_BASE, name="HEAT4", n_heads=2,
                  graph_pooling_type="mean"),
    "GCN_asap": dict(_ZOO_BASE, name="GCN", num_layers=3,
                     graph_pooling_type="asap", pool_k=8),
}


def _typed_batch(is_hetero, seed=0):
    """Two random KNN-degree slides (8 out-edges per node) batched and
    edge-sorted on the host; explicit self-loops for homogeneous models."""
    rng = np.random.RandomState(seed)
    graphs = []
    for n in (300, 257):
        e = 8 * n
        graphs.append(from_arrays(
            rng.randn(n, 32).astype(np.float32), np.repeat(np.arange(n), 8),
            rng.randint(0, n, e), node_type=rng.randint(0, 6, n),
            esign=rng.randint(0, 2, e), sim=rng.uniform(-1, 1, e),
            n_node_types=6 if is_hetero else 1,
            add_self_loops=not is_hetero))
    return sort_graph_edges(batch_graphs(graphs))


@pytest.mark.parametrize("family", sorted(ZOO))
def test_typed_train_step_on_card_matches_cpu(cuda, family):
    """One TypedGraph Adam step per zoo family from the same weights,
    batch, augmentation and dropout masks (those the CPU step drew):
    loss to 1e-5 relative, every parameter's gradient to 1e-4 relative
    L2 or judged by float64 (assert_grads_match), running statistics to
    1e-4."""
    _typed_step_matches(cuda, ZOO[family], seed=0)


@pytest.mark.parametrize("family", sorted(set(BRCA) - {"HEAT4", "GCN_asap"}))
def test_typed_train_step_on_card_matches_cpu_at_brca_width(cuda, family):
    """One TypedGraph Adam step per zoo family at its BRCA config's
    widths (in 1024) on two seeded slides of 1000-3000 nodes, the masks
    the CPU step drew replayed on the card: loss to 1e-5 relative,
    gradients by the float64 judge. (GCN_asap's is
    test_asap_step_on_card_matches_cpu_at_brca_width; HEAT4's lattice
    step test_lattice_train_step_on_card_matches_cpu_at_brca_width.)"""
    section = load_config(BRCA[family][0])["GNN"]
    host = _seeded_slides(int(section["in_dim"]),
                          parse_gnn_model(section)[1])
    (l_cpu, _, _), (l_dev, _, _), text, failed, _ = _typed_step_judged(
        cuda, section, 0, host)
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    assert not failed, (failed, text)


ASAP_BRCA = ROOT / "configs/BRCA/GCN_asap_classification.yml"


def _seeded_slides(in_dim, hetero, seed=0):
    """Two slides of 1000-3000 nodes (the second shifted by +0.5), node
    types uniform in [0, 6), radius-9 KNN graphs built on the CPU."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1000, 3001, 2)
    n = int(sizes.max())
    feat = np.zeros((2, n, in_dim), np.float32)
    mask = np.zeros((2, n), bool)
    for i, m in enumerate(sizes):
        feat[i, :m] = rng.randn(m, in_dim) + 0.5 * i
        mask[i, :m] = True
    return build_batch_device(
        torch.from_numpy(feat), torch.from_numpy(rng.randint(0, 6, (2, n))),
        torch.from_numpy(mask), 9, 6, add_self_loops=not hetero)


@functools.lru_cache(maxsize=1)
def _brca_asap():
    section = load_config(ASAP_BRCA)["GNN"]
    return section, _seeded_slides(int(section["in_dim"]), False)


@pytest.mark.parametrize("seed", range(12))
def test_asap_step_on_card_matches_cpu_at_brca_width(cuda, seed):
    """The ASAPGCN step at configs/BRCA/GCN_asap_classification.yml's
    width (in 1024, hidden 256, 3 layers, pool_k 32) on two seeded slides
    of 1000-3000 nodes, from twelve seeded inits. Its master query and
    attention bias reach the loss only through per-centre softmaxes, so
    their exact gradients are 0 or nearly so and f32 leaves rounding
    noise of either sign on either device; the float64 judge must accept
    it on every init. Prints, per init, the judge's text and the largest
    distance of the CPU's and the card's f32 gradients, and of the
    card's float64 ones where the judge ran them, from the CPU's float64
    gradients, over the largest gradient norm (run with -rP to see it)."""
    section, host = _brca_asap()
    (l_cpu, _, m_cpu), (l_dev, _, m_dev), text, failed, g64 = \
        _typed_step_judged(cuda, section, seed, host)
    g32 = {"cpu32": gradcheck._grads(m_cpu.named_parameters()),
           "card32": gradcheck._grads(m_dev.named_parameters())}
    if "card" in g64:
        g32["card64"] = g64["card"]
    top = max(float(g.norm()) for g in g64["cpu"].values())
    dist = {k: max(float((g[n] - w).norm()) for n, w in g64["cpu"].items())
            / top for k, g in g32.items()}
    print(f"seed {seed}: loss card {l_dev:.9g} CPU {l_cpu:.9g}; largest "
          f"distance from the CPU's float64 gradients over the largest "
          f"gradient norm: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                         dist.items()) + f"; {text}")
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    assert not failed, (failed, text)


def test_gradcheck_fails_a_planted_fault_on_card(cuda):
    """The BRCA-width ASAPGCN step with a card-only fault, ASAP's master
    query projection (lin_q) negated in the card's f32 and float64
    models: the judge fails it."""
    section, host = _brca_asap()

    def plant(m):
        m.asap.lin_q.register_forward_hook(lambda mod, inp, out: -out)

    *_, text, failed, _ = _typed_step_judged(cuda, section, 0, host,
                                             plant=plant)
    print(f"lin_q negated on the card: judge fails {len(failed)} tensors "
          f"{failed}; {text}")
    assert failed, text


def test_gradcheck_fails_tf32_products_on_card(cuda):
    """The BRCA-width ASAPGCN step with the card's f32 products in TF32
    (10-bit mantissas): the judge fails it."""
    section, host = _brca_asap()
    *_, text, failed, _ = _typed_step_judged(cuda, section, 0, host,
                                             tf32=True)
    print(f"TF32 products on the card: judge fails {len(failed)} tensors "
          f"{failed}; {text}")
    assert failed, text


def _typed_step_matches(cuda, section, seed):
    (l_cpu, p_cpu, m_cpu), (l_dev, p_dev, m_dev), text, failed, _ = \
        _typed_step_judged(cuda, section, seed,
                           _typed_batch(parse_gnn_model(section)[1]))
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    torch.testing.assert_close(p_dev, p_cpu, rtol=1e-5, atol=1e-5)
    assert not failed, (failed, text)
    v_cpu, v_dev = (convert.to_flax_variables(m) for m in (m_cpu, m_dev))
    for key, a in _flat(v_dev.get("batch_stats", {})).items():
        assert np.abs(a - _flat(v_cpu["batch_stats"])[key]).max() <= 1e-4, key


def _typed_step_judged(cuda, section, seed, host, plant=None, tf32=False):
    """One TypedGraph Adam step of `section`'s model from `seed`'s init
    on the graph `host`, on the CPU and on the card, with the
    augmentation and dropout masks the CPU step drew; `plant(model)`
    alters the card's models, `tf32` runs the card's f32 products in
    TF32. Returns ((loss, prob, model) on the CPU, the same on the card,
    then judge_grads' text, failed names and float64 gradients)."""
    model, is_hetero = parse_gnn_model(section)
    convert.init_flax_like_(model, seed=seed)
    optim = {"opt_method": "ADAM", "lr": 1e-3, "weight_decay": 5e-3}
    loss_fn = parse_loss({"loss": "CE"})
    labels, weights = torch.tensor([0, 1]), torch.tensor([1.0, 1.0])
    gen = torch.Generator().manual_seed(1)
    g_cpu = host.to_torch(torch.device("cpu"))
    masks = transforms.draw_train_masks(g_cpu, gen)
    drops = DropSource(gen)
    card = convert.init_flax_like_(parse_gnn_model(section)[0],
                                   seed=seed).to(cuda)
    if plant is not None:
        plant(card)
    base64 = convert.init_flax_like_(parse_gnn_model(section)[0], seed=seed)
    base64.double()
    res = []
    for dev, m, src in ((torch.device("cpu"), model, drops),
                        (cuda, card, None)):
        if src is None:
            src = DropSource(masks=[a.to(dev) for a in drops.used])
        torch.backends.cuda.matmul.allow_tf32 = tf32 and dev.type == "cuda"
        try:
            loss, prob = typed_train_step(
                m, parse_optimizer(optim, m.parameters()), loss_fn,
                host.to_torch(dev), labels.to(dev), weights.to(dev),
                is_hetero,
                masks=transforms.TrainMasks(*(a.to(dev) for a in masks)),
                drops=src)
        finally:
            set_cuda_numerics()
        res.append((float(loss), prob.cpu(), m))

    def run64(m, dev):
        g64 = host.to_torch(dev)
        with gradcheck.float64_default():
            typed_train_step(
                m, parse_optimizer(optim, m.parameters()), loss_fn,
                g64.replace(feat=g64.feat.double(), sim=g64.sim.double()),
                labels.to(dev), weights.double().to(dev), is_hetero,
                masks=transforms.TrainMasks(*(a.to(dev) for a in masks)),
                drops=DropSource(masks=drops.used))

    return (*res, *judge_grads(res[0][2].named_parameters(),
                               res[1][2].named_parameters(), run64, base64,
                               cuda, plant))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("family", sorted(ZOO))
def test_typed_predictor_on_card_launches_the_knn_per_slide(cuda, family):
    """SlidePredictor's TypedGraph path on the card, for every zoo family
    (HEAT4 with the lattice off), builds each slide's graph through the
    KNN kernel (one launch per slide, no other kernel) and answers as
    the CPU path does."""
    gnn = dict(ZOO[family], in_dim=64)
    model, _ = parse_gnn_model(gnn)
    variables = convert.to_flax_variables(convert.init_flax_like_(model, 0))
    rng = np.random.RandomState(3)
    slides = [(rng.randn(n, 64).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32)) for n in (300, 41, 700)]
    on_card, on_cpu = (SlidePredictor({"GNN": gnn}, variables=variables,
                                      device=d, use_lattice=False)
                       for d in (cuda, "cpu"))
    assert not on_card.uses_lattice(3, 768)
    kernels.reset_launch_counts()
    got = on_card.predict_many(slides)
    assert kernels.launch_counts() == _counts(knn_l2_fused=3)
    np.testing.assert_allclose(got, on_cpu.predict_many(slides), atol=1e-4)


def test_server_round_trip_on_card(cuda):
    """BatchingServer over a predictor on the card (HEAT4 at
    configs/BRCA/HEAT4_kimia_classification.yml's widths): concurrent
    feature requests of 41-2048 patches (grouped and padded to
    max_batch) answer as the CPU predictor answers each slide alone, one
    KNN launch per padded slide, and /healthz reports no version for
    given variables; then two concurrent pixel requests of 300 patches
    (seeded KimiaNet and HoVer-Net typing, chunks of 128) answer as the
    same patches served alone through the predictor, with each chunk's
    DenseNet and bn_act launches and one KNN per padded slide."""
    import io
    import json
    import threading
    import urllib.request

    from wsi_hgnn_tpu_torch.serve import BatchingServer

    gnn = load_config(HEAT4_BRCA)["GNN"]
    model = parse_lattice_twin(gnn)
    variables = convert.to_flax_variables(convert.init_flax_like_(model, 0))
    on_card = SlidePredictor({"GNN": gnn}, variables=variables, device=cuda)
    on_cpu = SlidePredictor({"GNN": gnn}, variables=variables, device="cpu")
    on_card.enable_pixels(hovernet_config={"batch_size": 128, "mode": "fast"})
    rng = np.random.RandomState(5)
    slides = [(rng.randn(n, 1024).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32))
              for n in (2048, 1900, 700, 650, 41)]
    px = [rng.randint(0, 256, (300, 256, 256, 3)).astype(np.uint8)
          for _ in range(2)]
    px_alone = [on_card.predict_many_pixels([p])[0] for p in px]
    results = [None] * (len(slides) + len(px))
    server = BatchingServer(on_card, max_batch=4, max_wait_ms=500.0)
    server.start()

    def post(i):
        buf = io.BytesIO()
        if i < len(slides):
            np.savez(buf, features=slides[i][0], node_types=slides[i][1])
        else:
            np.savez(buf, pixels=px[i - len(slides)])
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = json.loads(r.read())

    def post_all(ids):
        threads = [threading.Thread(target=post, args=(i,), daemon=True)
                   for i in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()

    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}{path}", timeout=30) as r:
            return json.loads(r.read())

    try:
        before = kknn.knn_l2_fused.launches
        post_all(range(len(slides)))
        stats = get("/stats")
        assert get("/healthz")["model_version"] is None
        knn = kknn.knn_l2_fused.launches - before
        kernels.reset_launch_counts()
        post_all(range(len(slides), len(results)))
        px_launches = kernels.launch_counts()
        px_stats = get("/stats")
    finally:
        server.stop()
    assert stats["requests"] == 5 and stats["errors"] == 0
    assert knn == 4 * stats["batches"]
    assert px_stats["requests"] == 7 and px_stats["errors"] == 0
    for s, r in zip(slides, results):
        np.testing.assert_allclose(r["probs"], on_cpu.predict(*s), atol=1e-4)
    for r, want in zip(results[len(slides):], px_alone):
        np.testing.assert_allclose(r["probs"], want, atol=1e-4)
    # three chunks of 128 for each 300-patch request; each group's graphs,
    # padded to max_batch by repeating features
    assert px_launches == _counts(
        knn_l2_fused=4 * (px_stats["batches"] - stats["batches"]),
        dense_layer_fused=6 * 58, transition_fused=6 * 3, bn_act=6 * 76)


def _seeded_tree(module, seed):
    return convert.to_flax_variables(convert.init_flax_like_(module, seed))


def _rel_l2(got, want):
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def test_hover_encoder_chunk_on_card_matches_cpu(cuda):
    """A 'hover' encoder chunk (HoVer-Net encoder, tp typing and fc1, here
    64 wide) in f32 on the card against the same weights on the CPU:
    features to 1e-4 relative L2, node types equal; the bf16 encoder the
    card runs in production to 0.1 (as served features are held)."""
    from wsi_hgnn_tpu_torch.models.featurizers import (HoVerNet,
                                                       hovernet_full_apply,
                                                       make_cnn_encoder)

    tree = _seeded_tree(HoVerNet(6, "fast", feat_dim=64), 3)
    px = np.random.RandomState(4).randint(0, 256, (4, 256, 256, 3)
                                          ).astype(np.uint8)
    x = torch.from_numpy(px).float() / 255.0
    model = convert.load_flax_variables(HoVerNet(6, "fast", feat_dim=64),
                                        tree).eval()
    with torch.inference_mode():
        f_cpu, t_cpu = hovernet_full_apply(model, x)
        f_card, t_card = hovernet_full_apply(model.to(cuda), x.to(cuda))
    assert _rel_l2(f_card.cpu(), f_cpu) <= 1e-4
    assert torch.equal(t_card.cpu(), t_cpu)
    enc = make_cnn_encoder("hover", {"feature_dim": 64, "n_node_type": 6},
                           {"mode": "fast"}, {}, pad_batch_to=4, device=cuda,
                           hover_variables=tree)
    f_bf16, _ = enc(px)
    assert _rel_l2(torch.from_numpy(f_bf16), f_cpu) <= 0.1


# bn_act against the plain ops on the card: bit for bit against torch's
# own BatchNorm kernel (bf16 maps always take it; f32 maps with cuDNN
# off); torch gives f32 maps to cuDNN when it is on, whose BatchNorm
# rounds the same formula its own way (2.4e-7 at most on these maps)
BN_ACT_CUDNN_F32 = dict(rtol=1e-6, atol=1e-6)


def _hover_typing_card(cuda, dtype, seed=3):
    """The typing net seeded with jittered running stats, on the card in
    `dtype`, channels-last (as featurizers._card_dtype places it)."""
    from test_torch_bn_act import _seeded_typing

    return _seeded_typing(seed).to(cuda, dtype,
                                   memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bn_act_equals_plain_at_every_typing_shape(cuda, dtype):
    """Every BNRelu call of a typing forward (C = 64 .. 2048 and the dense
    blocks' concat widths 128 + 32i and 256 + 32i, H = 256 down to 46; the
    three forms) against bn_relu_reference on the same card operands:
    sums and outputs bit for bit against torch's own BatchNorm kernel, and
    f32 within BN_ACT_CUDNN_F32 of cuDNN's. 76 launches a forward."""
    from wsi_hgnn_tpu_torch.kernels import hovernet as kh
    from wsi_hgnn_tpu_torch.models.featurizers import hovernet as thv

    model = _hover_typing_card(cuda, dtype)
    seen = set()

    def compare(mod, args, kwargs, out):
        x, residual = args[0], (args[1] if len(args) > 1 else None)
        keep = kwargs.get("keep_sum", False)
        with torch.backends.cudnn.flags(enabled=False):
            want = kh.bn_relu_reference(x, mod.bn, residual, keep)
        cudnn = kh.bn_relu_reference(x, mod.bn, residual, keep)
        if keep:
            assert torch.equal(out[0], want[0])
            out, want, cudnn = out[1], want[1], cudnn[1]
        assert out.dtype == dtype and out.is_contiguous(
            memory_format=torch.channels_last)
        where = f"{tuple(x.shape)} residual={residual is not None}"
        assert torch.equal(out, want), where
        if dtype == torch.float32:
            torch.testing.assert_close(out, cudnn, **BN_ACT_CUDNN_F32,
                                       msg=where)
        seen.add((x.shape[1], x.shape[2], residual is not None, keep))

    for m in model.modules():
        if isinstance(m, thv.BNRelu):
            m.register_forward_hook(compare, with_kwargs=True)
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(4))
    before = kernels.launch_counts()["bn_act"]
    with torch.inference_mode():
        thv.hovernet_typing_apply(model, x.to(cuda, dtype))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bn_act"] - before == 76
    chans = {c for c, *_ in seen}
    assert {64, 128, 256, 512, 1024, 2048} <= chans
    assert {128 + 32 * i for i in range(5)} | {256 + 32 * i
                                               for i in range(9)} <= chans
    assert {h for _, h, *_ in seen} >= {256, 128, 64, 32, 164, 46}
    assert {(r, k) for *_, r, k in seen} == {(False, False), (True, True),
                                             (True, False)}


def test_fused_typing_net_matches_the_unfused_on_pool_patches(cuda,
                                                              monkeypatch):
    """The typing net as served (bn_act, pads in the convolutions) against
    the unfused net (bn_relu_reference, tf_same_pad copies) on 32 of the
    benchmark's structured pool patches with its calibrated seeded
    weights, bf16 on the card: the same node types; tp logits within the
    bf16 tolerance (cuDNN may take another algorithm for a convolution
    that pads itself); 76 launches a forward (the unfused net none)."""
    from test_torch_bn_act import _tf_same_pad_route
    from wsi_hgnn_tpu_torch.kernels import hovernet as kh
    from wsi_hgnn_tpu_torch.models.featurizers import _norm_pixels
    from wsi_hgnn_tpu_torch.models.featurizers import hovernet as thv

    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    import models as bench_models
    from reference import weights as W
    from run import load_cell

    _, cfg = load_cell("heat4-serve-pixels")
    pool = bench_models.patch_pool(48, 256, 11, cuda)
    _, hover = bench_models.cnn_weights(cfg, 12, cuda, pool[32:])
    model = convert.load_flax_variables(
        thv.HoVerNet.typing(6, "fast"), W.to_numpy(hover)).eval().to(
        cuda, torch.bfloat16, memory_format=torch.channels_last)
    route = _tf_same_pad_route(model)
    x = _norm_pixels(torch.from_numpy(pool[:32]).to(cuda)).to(torch.bfloat16)
    xt = thv._nchw(thv._constructor_orientation(x))

    def tp_of(m):
        return m.decode_branch("tp", m.encode(xt)).permute(0, 2, 3, 1)

    before = kernels.launch_counts()["bn_act"]
    with torch.inference_mode():
        got = tp_of(model)
        assert kernels.launch_counts()["bn_act"] - before == 76
        monkeypatch.setattr(thv, "bn_act", kh.bn_relu_reference)
        want = tp_of(route)
    assert kernels.launch_counts()["bn_act"] - before == 76
    types_got = thv.node_types_on_device(got)
    assert torch.equal(types_got, thv.node_types_on_device(want))
    assert len(set(types_got.tolist())) > 1     # the votes are not all one
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_efficientnet_chunk_on_card_matches_cpu(cuda):
    """An EfficientNet-B4 chunk in f32 on the card against the CPU to 1e-4
    relative L2; the production 'efficientnet-b4' encoder (bf16, typing
    inline) to 0.1 with the CPU's node types from the same typing net."""
    from wsi_hgnn_tpu_torch.models.featurizers import (EfficientNet,
                                                       HoVerNet,
                                                       efficientnet_apply,
                                                       make_cnn_encoder)

    tree = _seeded_tree(EfficientNet.from_name("efficientnet-b4", 1024), 5)
    typing = _seeded_tree(HoVerNet.typing(6, "fast"), 6)
    px = np.random.RandomState(7).randint(0, 256, (8, 256, 256, 3)
                                          ).astype(np.uint8)
    x = torch.from_numpy(px).float() / 255.0
    model = convert.load_flax_variables(
        EfficientNet.from_name("efficientnet-b4", 1024), tree).eval()
    with torch.inference_mode():
        f_cpu = efficientnet_apply(model, x)
        f_card = efficientnet_apply(model.to(cuda), x.to(cuda)).cpu()
    assert _rel_l2(f_card, f_cpu) <= 1e-4
    enc = make_cnn_encoder("efficientnet-b4",
                           {"feature_dim": 1024, "n_node_type": 6},
                           {"mode": "fast"}, {}, with_typing=True,
                           pad_batch_to=8, device=cuda,
                           efficientnet_variables=tree,
                           hover_variables=typing)
    f_bf16, types = enc(px)
    assert _rel_l2(torch.from_numpy(f_bf16), f_cpu) <= 0.1
    assert types.shape == (8,) and types.dtype == np.int32
    assert ((types >= 0) & (types < 6)).all()


def test_uni2h_chunk_on_card_matches_the_f32_reference(cuda, monkeypatch):
    """The 'uni2-h' encoder as served (bf16, the 24 blocks at the model
    card's widths) on 16 of the benchmark's structured pool patches with
    its seeded weights, against the plain f32 reference
    (benchmark/reference/vit.py): every row within the cell's
    `feat_rel_l2` limit, no node types, and the attention on the card's
    flash kernel (the profiler's device events name it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wsi_hgnn_tpu_torch.models.featurizers import make_cnn_encoder

    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    import models as bench_models
    from reference import vit as ref_vit
    from run import load_cell

    workload, cfg = load_cell("uni2h-serve-pixels")
    arch = ref_vit.arch_of(cfg)
    w = ref_vit.make_weights(ref_vit.spec(arch), 21, cuda)
    pool = bench_models.patch_pool(16, 256, 22, cuda)
    enc = make_cnn_encoder("uni2-h", {"feature_dim": 1536}, {}, {},
                           pad_batch_to=16, device=cuda, vit_state_dict=w)
    enc(pool)   # the first call picks cuBLAS's and the attention's kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got, types = enc(pool)
    kernels_run = {e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA}
    assert any("flash" in k.lower() for k in kernels_run), sorted(kernels_run)
    assert types is None and got.shape == (16, 1536)
    want = ref_vit.features(w, torch.from_numpy(pool).to(cuda), arch)
    rel = ((torch.from_numpy(got).to(cuda) - want).norm(dim=1)
           / want.norm(dim=1))
    print(f"uni2-h bf16 against f32: relative L2 {rel.min():.4g} - "
          f"{rel.max():.4g}")
    assert float(rel.max()) <= workload["limits"]["feat_rel_l2"]


# UNI2-h's one-pass block kernels (kernels/vit.py) against the unfused ops
# on the card, at a chunk's rows (256 patches x 265 tokens) and a ragged
# count
VIT_ROWS = (256 * 265, 1001)


def _bf16_ulps_apart(got, want):
    """|got - want| in units of the bf16 spacing at the larger of the two
    magnitudes (elementwise)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    return (g - w).abs() / torch.ldexp(torch.ones_like(g), e - 8)


@pytest.mark.parametrize("rows", VIT_ROWS)
def test_swiglu_equals_silu_times_gate_bit_for_bit(cuda, rows):
    """swiglu on fc1's [rows, 8192] bf16 output equals F.silu(a) * b on
    the card bit for bit (values over +-12, SiLU's saturation on both
    sides included), one launch."""
    from wsi_hgnn_tpu_torch.kernels import vit as kv

    gen = torch.Generator(device=cuda).manual_seed(rows)
    h = (torch.randn(rows, 8192, generator=gen, device=cuda) * 4
         ).to(torch.bfloat16)
    before = kv.swiglu.launches
    with torch.inference_mode():
        got = kv.swiglu(h)
        want = kv.swiglu_reference(h)
    torch.cuda.synchronize()
    assert kv.swiglu.launches == before + 1
    assert got.shape == (rows, 4096) and torch.equal(got, want)


@pytest.mark.parametrize("form", ["update_and_norm", "norm_alone",
                                  "update_alone"])
@pytest.mark.parametrize("rows", VIT_ROWS)
def test_add_layer_norm_stream_and_norm_equal_torch_bit_for_bit(
        cuda, rows, form):
    """add_layer_norm at UNI2-h's width: the f32 stream equals
    torch.addcmul(x, gamma, branch) bit for bit; the bf16 output equals
    F.layer_norm(x.to(bf16)) with the norm's bf16 weight and bias bit for
    bit, the kernel taking the Welford order of torch's
    vectorized_layer_norm_kernel as of torch 2.11 (csrc/vit_block.cu).
    A failure prints how many bf16 ulps apart the outputs are."""
    from wsi_hgnn_tpu_torch.kernels import vit as kv

    d = 1536
    gen = torch.Generator(device=cuda).manual_seed(rows + 7)
    x = torch.randn(rows, d, generator=gen, device=cuda) * 3 + 0.5
    gamma = (0.2 * torch.exp(0.1 * torch.randn(d, generator=gen,
                                               device=cuda))
             ).to(torch.bfloat16)
    branch = torch.randn(rows, d, generator=gen, device=cuda
                         ).to(torch.bfloat16)
    norm = torch.nn.LayerNorm(d, eps=1e-6).to(cuda)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(d, generator=gen, device=cuda) + 0.5)
        norm.bias.copy_(torch.randn(d, generator=gen, device=cuda) * 0.1)
    norm = norm.to(torch.bfloat16)
    use_branch, use_norm = form != "norm_alone", form != "update_alone"
    with torch.inference_mode():
        want_x = torch.addcmul(x, gamma, branch) if use_branch else x.clone()
        want_y = norm(want_x.to(torch.bfloat16)) if use_norm else None
        stream = x.clone()
        before = kv.add_layer_norm.launches
        got_y = kv.add_layer_norm(stream, gamma if use_branch else None,
                                  branch if use_branch else None,
                                  norm if use_norm else None)
    torch.cuda.synchronize()
    assert kv.add_layer_norm.launches == before + 1
    assert torch.equal(stream, want_x)
    if not use_norm:
        assert got_y is None
        return
    ulps = float(_bf16_ulps_apart(got_y, want_y).max())
    same = float((got_y == want_y).float().mean())
    assert torch.equal(got_y, want_y), (
        f"add_layer_norm {form} rows {rows}: up to {ulps:.3g} bf16 ulps "
        f"from torch's LayerNorm, {same:.6f} of the outputs equal "
        f"(torch {torch.__version__})")


def test_vit_kernels_refuse_what_they_do_not_take(cuda):
    """On the card the wrappers raise, and launch nothing, for a wrong
    dtype, a misaligned or strided operand, and an operand that needs a
    gradient outside inference mode."""
    from wsi_hgnn_tpu_torch.kernels import vit as kv

    bf = dict(dtype=torch.bfloat16, device=cuda)
    h = torch.randn(8, 64, **bf)
    x = torch.randn(8, 96, device=cuda)
    g, r = torch.randn(96, **bf), torch.randn(8, 96, **bf)
    norm = torch.nn.LayerNorm(96, eps=1e-6).to(**bf)
    before = (kv.swiglu.launches, kv.add_layer_norm.launches)
    bad_swiglu = (h.float(), h[:, :48],
                  torch.randn(8 * 64 + 1, **bf)[1:].view(8, 64),
                  h.clone().requires_grad_())
    bad_aln = ((x.to(torch.bfloat16), g, r, norm), (x, g.float(), r, norm),
               (x, g, r.float(), norm), (x, g, r, norm.float()),
               (torch.randn(8 * 96 + 1, device=cuda)[1:].view(8, 96), g, r,
                norm),
               (x.t().contiguous().t(), g, r, norm),
               (x, g, r.clone().requires_grad_(), norm))
    with torch.inference_mode():     # all but the gradient cases
        for arg in bad_swiglu[:-1]:
            with pytest.raises(ValueError):
                kv.swiglu(arg)
        for args in bad_aln[:-1]:
            with pytest.raises(ValueError):
                kv.add_layer_norm(*args)
    with pytest.raises(ValueError, match="backward"):
        kv.swiglu(bad_swiglu[-1])
    with pytest.raises(ValueError, match="backward"):
        kv.add_layer_norm(*bad_aln[-1])
    assert (kv.swiglu.launches, kv.add_layer_norm.launches) == before


def test_uni2h_request_launches_both_kernels_per_chunk(cuda, monkeypatch):
    """A 4096-patch request through the uni2h cell's predictor (chunks of
    256): 16 chunks of 24 swiglu and 1 + 24 x 2 add_layer_norm launches,
    none of HoVer-Net's or KimiaNet's kernels, features finite."""
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    import models as bench_models
    from reference import gat
    from reference import vit as ref_vit
    from reference import weights as W
    from run import load_cell

    _, cfg = load_cell("uni2h-serve-pixels")
    arch = ref_vit.arch_of(cfg)
    chunk = int(cfg["pixels"]["chunk"])
    pred = bench_models.predictor(
        cfg, W.make_weights(gat.spec(cfg["GNN"]), 31, cuda), cuda)
    pred.enable_pixels(chunk=chunk, encoder_name="uni2-h",
                       encoder_config={"vit": arch},
                       vit_state_dict=ref_vit.make_weights(
                           ref_vit.spec(arch), 32, cuda))
    pool = bench_models.patch_pool(4096, 256, 33, cuda)
    kernels.reset_launch_counts()
    feats, _ = pred.featurize(pool)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    chunks = 4096 // chunk
    assert chunk == 256 and chunks == 16
    assert counts["swiglu"] == chunks * 24
    assert counts["add_layer_norm"] == chunks * 49
    assert counts["dense_layer_fused"] == counts["transition_fused"] \
        == counts["bn_act"] == 0
    assert feats.shape == (4096, 1536) and np.isfinite(feats).all()


def test_chunks_launched_ahead_equal_chunks_run_one_at_a_time(cuda,
                                                              monkeypatch):
    """KimiaNet with HoVer-Net typing (the heat4 pixel path) on three
    chunks of pool patches: each chunk launched before the last is
    finished, as serve.featurize runs them, gives the features and types
    of the chunks run one at a time, bit for bit (the pinned upload and
    download buffers of neighbouring chunks do not mix)."""
    from wsi_hgnn_tpu_torch.models.featurizers import make_cnn_encoder

    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    import models as bench_models

    pool = bench_models.patch_pool(24, 256, 5, cuda)
    enc = make_cnn_encoder("kimia", {"feature_dim": 1024, "n_node_type": 6},
                           {}, {}, with_typing=True, pad_batch_to=8,
                           device=cuda)
    chunks = [pool[i:i + 8] for i in (0, 8, 16)]
    want = [enc(c) for c in chunks]
    got, pending = [], enc.launch(chunks[0])
    for c in chunks[1:]:
        launched = enc.launch(c)
        got.append(enc.finish(pending))
        pending = launched
    got.append(enc.finish(pending))
    for (f, t), (wf, wt) in zip(got, want):
        np.testing.assert_array_equal(f, wf)
        np.testing.assert_array_equal(t, wt)


def test_native_packer_builds_and_matches_numpy_on_card_machine(cuda):
    """The native packer built by this machine's g++: batches and edge
    sorts equal the numpy path bit for bit, and the batch moves to the
    card intact."""
    from wsi_hgnn_tpu_torch import native

    assert native.build().exists()
    rng = np.random.RandomState(0)
    graphs = [from_arrays(rng.randn(n, 16).astype(np.float32),
                          rng.randint(0, n, e), rng.randint(0, n, e),
                          node_type=rng.randint(0, 6, n),
                          esign=rng.randint(0, 2, e), sim=rng.randn(e),
                          n_node_types=6, node_capacity=256,
                          edge_capacity=1024)
              for n, e in ((100, 700), (250, 1000), (7, 20))]
    got = sort_graph_edges(batch_graphs(graphs))
    want = sort_graph_edges(batch_graphs(graphs, native=False), native=False)
    for f in ("feat", "node_type", "node_graph", "node_mask", "src", "dst",
              "esign", "sim", "edge_mask"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(
        torch.from_numpy(got.feat).to(cuda).cpu().numpy(), got.feat)


# ---------------------------------------------------------------------------
# the explainers and the MIL baselines on the card
# ---------------------------------------------------------------------------
def _explain_model(cuda):
    """A small HEAT4 and a typed slide of 90 nodes, on the CPU and on the
    card."""
    section = dict(SMALL_GNN, in_dim=32, hidden_dim=32)
    model, _ = parse_gnn_model(section)
    convert.init_flax_like_(model, seed=3).eval()
    rng = np.random.RandomState(8)
    n, e = 90, 720
    host = from_arrays(rng.randn(n, 32).astype(np.float32),
                       np.repeat(np.arange(n), 8), rng.randint(0, n, e),
                       node_type=rng.randint(0, 6, n),
                       esign=rng.randint(0, 2, e), sim=rng.uniform(-1, 1, e),
                       n_node_types=6)
    return model, copy.deepcopy(model).to(cuda), host


def test_gem_chunks_on_card_match_cpu(cuda):
    """HetGemExplainer's leave-one-out scores (flat batches of 32 copies,
    a padded tail chunk) on the card against the CPU, the model's output
    layer scaled so the tumour logit trails by 3 (the loss then moves
    with every deletion): relative L2 1e-4, and each score within rtol
    1e-4 plus an atol of twice GRAD_F32 times the f32 rounding that
    randomly rounded float64 explanations on the card show (card and CPU
    each round), which must be under a hundredth of the median score and
    which all-zero and sign-flipped scores fail."""
    from wsi_hgnn_tpu_torch.explain import HetGemExplainer

    m_cpu, m_dev, host = _explain_model(cuda)
    explainer = HetGemExplainer(host.to_torch(torch.device("cpu")), m_cpu, 1)
    with torch.no_grad():
        z = m_cpu(explainer.graph)[0]
        for m in (m_cpu, m_dev):
            m.head.weight.mul_(-3.0 / float(z[1] - z[0]))
            m.head.bias.mul_(-3.0 / float(z[1] - z[0]))
    want = explainer.flat_scores()
    got = HetGemExplainer(host.to_torch(cuda), m_dev, 1).flat_scores()
    m64 = copy.deepcopy(m_dev).double()
    g64 = host.to_torch(cuda)
    g64 = g64.replace(feat=g64.feat.double(), sim=g64.sim.double())

    def explain64():
        return HetGemExplainer(g64, m64, 1).flat_scores()

    with gradcheck.float64_default():
        s64 = explain64()
    atol = 2 * gradcheck.GRAD_F32 * gradcheck.output_spread(
        explain64, s64, device=cuda)
    assert got.shape == want.shape == (90,)
    assert 0 < atol <= 1e-2 * np.median(np.abs(want))
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    for wrong in (np.zeros_like(want), -want):
        assert not np.allclose(wrong, want, rtol=1e-4, atol=atol)


def test_gnn_explainer_steps_on_card_match_cpu(cuda):
    """Five GNNExplainer Adam steps from the same initial logits on the
    card and the CPU: masks to 1e-4, the model's parameters unfrozen
    after the loop."""
    from wsi_hgnn_tpu_torch.explain import GNNExplainer

    m_cpu, m_dev, host = _explain_model(cuda)
    rng = np.random.RandomState(2)
    init = (rng.randn(host.num_nodes).astype(np.float32) * 0.1,
            rng.randn(host.num_edges).astype(np.float32) * 0.2)
    out = []
    for dev, m in ((torch.device("cpu"), m_cpu), (cuda, m_dev)):
        g, node = GNNExplainer(host.to_torch(dev), lambda gr, f=None, m=m: m(
            gr if f is None else gr.replace(feat=f)), 1, epochs=5, model=m,
            init_logits=init).explain_node(None)
        out.append((node, g.edge_weight.cpu().numpy()))
        assert all(p.requires_grad for p in m.parameters())
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def _mil_step_matches(cuda, kind, d, n, cap, hidden, clusters, seeds,
                      ties=False):
    """One train_mil step of `kind` on a bag of n x d padded to `cap`
    (`seeds`: the bag's and the init's), on the card against the CPU:
    loss to 1e-5 relative, gradients by assert_grads_match. With `ties`,
    a card whose loss misses the CPU's f32 loss is held against the
    CPU's float64 step instead, at the same tolerances, for the loss and
    the gradients alike: a model that makes discrete choices (H2MIL's
    IHPool: fitness order statistics, nearest centres) can meet an input
    within f32 rounding of a tie, which the card's atomics decide one way
    or the other from run to run; a card that matches neither fails. gtn
    is
    GraphTransformer(2, d, hidden, clusters) over the bag's grid
    adjacency; h2mil is H2MIL(d, hidden) with dropout off (both devices
    compute one function) on the bag's synthetic tree (cell 4), and
    IHPool's weights, which no gradient reaches, must be exactly 0 on the
    card."""
    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models import mil
    from wsi_hgnn_tpu_torch.models.mil.h2mil import (build_tree_graph,
                                                     tree_to_torch)

    bag = np.random.RandomState(seeds[0]).randn(n, d).astype(np.float32)
    feats, mask = mil.pad_bag(bag, capacity=cap)
    if kind == "h2mil":
        tree = build_tree_graph(bag, train_mil.grid_coords(n), cell=4)
        model = mil.H2MIL(d, hidden, 2, dropout=0.0)
    elif kind == "gtn":
        model = mil.GraphTransformer(2, d, hidden, clusters)
        edges = mil.spatial_adjacency(
            [tuple(c) for c in train_mil.grid_coords(n)])
    else:
        model = (mil.ABMIL if kind == "abmil" else mil.DSMIL)(2, d)
    convert.init_flax_like_(model, seed=seeds[1])
    base64 = copy.deepcopy(model).double()

    def step(m, dev, dtype=torch.float32):
        if kind == "h2mil":
            opt = torch.optim.Adam(m.parameters(), lr=2e-4,
                                   weight_decay=5e-4)
            return train_mil.h2mil_train_step(
                m, opt, tree_to_torch(tree, dev, dtype), 1)
        f = torch.from_numpy(feats).to(dev, dtype)
        msk = torch.from_numpy(mask).to(dev)
        if kind == "gtn":
            opt = torch.optim.Adam(m.parameters(), lr=1e-3, weight_decay=5e-4)
            return train_mil.gtn_train_step(
                m, opt, f[None], train_mil.dense_adjacency(edges, cap, dev).to(
                    dtype), msk[None], 1)
        opt = torch.optim.Adam(m.parameters(), lr=2e-4, betas=(0.5, 0.9),
                               weight_decay=5e-3)
        return train_mil.bag_train_step(m, opt, kind, 2, f, msk, 1)

    def run64(m, dev):
        with gradcheck.float64_default():
            return step(m, dev, torch.float64)

    m_cpu, m_dev = copy.deepcopy(model), copy.deepcopy(model).to(cuda)
    l_cpu = float(step(m_cpu, torch.device("cpu")))
    l_dev = float(step(m_dev, cuda))
    if ties and abs(l_dev - l_cpu) > 1e-5 * abs(l_cpu):
        m_cpu = copy.deepcopy(base64)
        l_cpu = float(run64(m_cpu, torch.device("cpu")))
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    if kind == "h2mil":
        assert not m_dev.pool_1.weight_1.grad.any()
    assert_grads_match(m_cpu.named_parameters(), m_dev.named_parameters(),
                       run64, base64, cuda)


@pytest.mark.parametrize("kind", ["abmil", "dsmil", "gtn"])
def test_mil_step_on_card_matches_cpu(cuda, kind):
    """One train_mil step of each bag model (d 64, 300 instances; gtn
    hidden 32, 16 clusters) on the card against the CPU."""
    _mil_step_matches(cuda, kind, 64, 300, 320, 32, 16, seeds=(5, 1))


def test_h2mil_step_on_card_matches_cpu(cuda):
    """One H2MIL train_mil step (d 64, hidden 32, 300 instances) on the
    card against the CPU."""
    _mil_step_matches(cuda, "h2mil", 64, 300, 300, 32, None, seeds=(6, 2))


@pytest.mark.parametrize("kind", ["abmil", "dsmil", "gtn", "h2mil"])
def test_mil_step_on_card_matches_cpu_at_cohort_width(cuda, kind):
    """The same step on a bag of 1600 x 1024 (the largest bag of a cohort
    of 800-1600 KimiaNet features) at train_mil's default widths (gtn
    hidden 64, 100 clusters, capacity bucket_size(1600, base=64); H2MIL
    hidden 64), with the float64 side of an f32 tie accepted."""
    from wsi_hgnn_tpu_torch.graph.typed_graph import bucket_size

    cap = bucket_size(1600, base=64) if kind == "gtn" else 1600
    _mil_step_matches(cuda, kind, 1024, 1600, cap, 64, 100, seeds=(7, 3),
                      ties=True)


def test_simclr_step_on_card_matches_cpu(cuda):
    """One frozen-KimiaNet SimCLR step from the same weights and view
    draws: the card's fused f32 kernels, the CPU's plain versions, the
    float64 step through the KimiaNet module; loss to 1e-5 relative and
    fc_4's gradients by assert_grads_match (the frozen backbone's
    parameters, requires_grad off, take no part)."""
    from wsi_hgnn_tpu_torch.models.mil import simclr
    from wsi_hgnn_tpu_torch.tools import pretrain_simclr as tool

    model = convert.init_flax_like_(KimiaNet(64), seed=3).eval()
    for p in model.backbone.parameters():    # frozen: judged fc_4 alone
        p.requires_grad_(False)
    base64 = copy.deepcopy(model).double()
    imgs = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    views = simclr.draw_views(4, 64, 64, torch.Generator().manual_seed(5))

    def step(m, dev, project=None):
        if project is None:
            project, _ = tool.make_projector(m, "kimia", False, dev)
        opt = torch.optim.Adam(m.fc_4.parameters(), lr=1e-5,
                               weight_decay=1e-5)
        return simclr.simclr_train_step(project, opt,
                                        imgs.to(dev, m.fc_4.weight.dtype),
                                        views=views)

    def run64(m, dev):
        def project(x):
            with torch.no_grad():
                feats = m(x)[0]
            return m.fc_4(feats)
        with gradcheck.float64_default():
            step(m, dev, project)

    m_cpu, m_dev = copy.deepcopy(model), copy.deepcopy(model).to(cuda)
    kernels.reset_launch_counts()
    l_dev = float(step(m_dev, cuda))
    assert kernels.launch_counts()["dense_layer_fused"] == 58
    l_cpu = float(step(m_cpu, torch.device("cpu")))
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)

    assert_grads_match(m_cpu.named_parameters(), m_dev.named_parameters(),
                       run64, base64, cuda)


def test_fused_kimianet_f32_at_simclr_batch_matches_module(cuda):
    """SimCLR's frozen backbone on the card: the f32 kernel chain at
    B = 128 (two views of a 64-image batch), 256 x 256, against the
    module on the card, at the f32 chain's tolerance."""
    model = convert.init_flax_like_(KimiaNet(), seed=5).eval().to(cuda)
    fp = fuse_kimianet(convert.to_flax_variables(model), dtype=torch.float32,
                       device=cuda)
    x = torch.rand(128, 256, 256, 3, generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got, _ = kimianet_fused_apply(fp, x)
        want, _ = model(x)
    assert kernels.launch_counts() == {"knn_l2_fused": 0,
                                       "dense_layer_fused": 58,
                                       "transition_fused": 3,
                                       "bn_act": 0, "swiglu": 0,
                                       "add_layer_norm": 0}
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_graphcam_on_card_matches_cpu(cuda):
    """GraphCAM of every class on the card against the CPU: within 1e-4
    relative plus an atol of 3x the spread of randomly rounded float64
    runs (gradcheck.output_spread), as the explanation scores are judged,
    on a 1600-patch bag of 1024-d features (GraphTransformer hidden 64,
    100 clusters, train_mil's defaults); a sign-flipped and an all-zero
    cam fail that check."""
    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models import mil

    rng = np.random.RandomState(7)
    d, n, cap = 1024, 1600, 2048     # a 1600-patch bag of KimiaNet features
    model = convert.init_flax_like_(mil.GraphTransformer(2, d, 64, 100),
                                    seed=4).eval()
    feats, mask = mil.pad_bag(rng.randn(n, d).astype(np.float32),
                              capacity=cap)
    edges = mil.spatial_adjacency([tuple(c)
                                   for c in train_mil.grid_coords(n)])

    def cam(m, dev, c, dtype=torch.float32):
        f = torch.from_numpy(feats[None]).to(dev, dtype)
        adj = train_mil.dense_adjacency(edges, cap, dev).to(dtype)
        return mil.graphcam(m, f, adj, torch.from_numpy(mask[None]).to(dev),
                            c)

    m_dev = copy.deepcopy(model).to(cuda)
    m64 = copy.deepcopy(model).double()
    for c in range(2):
        want = cam(model, torch.device("cpu"), c).numpy()
        got = cam(m_dev, cuda, c).cpu().numpy()
        want64 = cam(m64, torch.device("cpu"), c, torch.float64)
        spread = gradcheck.output_spread(
            lambda: cam(copy.deepcopy(m64), torch.device("cpu"), c,
                        torch.float64), want64)
        atol = 3.0 * spread
        assert np.all(np.abs(got - want) <= atol + 1e-4 * np.abs(want))
        for wrong in (-got, np.zeros_like(got)):
            assert not np.all(np.abs(wrong - want)
                              <= atol + 1e-4 * np.abs(want))


def test_nested_bag_encoder_launch_counts(cuda, tmp_path):
    """--nested-bags --encoder kimia on the card: 58 dense-layer and 3
    transition launches per encoder chunk (low tiles, high tiles and the
    thumbnail chunked per slide), and the level-2 features equal to the
    encoder called on those tiles."""
    from PIL import Image

    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models.featurizers import make_cnn_encoder
    from wsi_hgnn_tpu_torch.models.mil.h2mil import scan_nested_bag
    from wsi_hgnn_tpu_torch.pipeline.patches import iter_patch_batches

    rng = np.random.RandomState(8)
    rows, chunks, bs = ["name,label"], 0, 8
    for i in range(2):
        bag = tmp_path / "tiles" / f"s{i}"
        bag.mkdir(parents=True)
        n_low = 5 + i
        for x in range(n_low):
            Image.fromarray(rng.randint(0, 256, (256, 256, 3)).astype(
                np.uint8)).save(bag / f"{x}_0.jpeg")
            (bag / f"{x}_0").mkdir()
            for dx in range(2):
                Image.fromarray(rng.randint(0, 256, (256, 256, 3)).astype(
                    np.uint8)).save(bag / f"{x}_0" / f"{2 * x + dx}_0.jpeg")
        Image.fromarray(rng.randint(0, 256, (256, 256, 3)).astype(
            np.uint8)).save(bag / "-1.jpeg")
        chunks += -(-n_low // bs) + -(-2 * n_low // bs) + 1
        rows.append(f"s{i},{i}")
    (tmp_path / "labels.csv").write_text("\n".join(rows) + "\n")
    encoder = make_cnn_encoder("kimia", {"feature_dim": 1024}, {}, {},
                               pad_batch_to=bs, device=cuda)
    kernels.reset_launch_counts()
    trees, _, _ = train_mil.load_nested_trees(
        str(tmp_path / "tiles"), str(tmp_path / "labels.csv"), "kimia",
        batch_size=bs, encoder=encoder)
    counts = kernels.launch_counts()
    assert counts["dense_layer_fused"] == 58 * chunks
    assert counts["transition_fused"] == 3 * chunks
    _, _, high, _, _, _ = scan_nested_bag(tmp_path / "tiles" / "s0")
    direct = np.concatenate([encoder(b)[0] for b in
                             iter_patch_batches(high, bs)])
    t = trees[0]
    n2 = int((t.node_type[t.node_mask] == 2).sum())
    np.testing.assert_array_equal(t.feats[int(t.node_mask.sum()) - n2:
                                          int(t.node_mask.sum())], direct)


# ---------------------------------------------------------------------------
# graph construction, tiling, explanation, the MIL tools and several
# devices, end to end on the card
# ---------------------------------------------------------------------------
CONSTRUCT_DIR = ROOT / "configs/GraphConstruction"
HEAT4_BRCA = ROOT / "configs/BRCA/HEAT4_kimia_classification.yml"
# a chunk of KimiaNet features with HoVer-Net typing inline
PER_CHUNK = {"dense_layer_fused": 58, "transition_fused": 3, "bn_act": 76}


def _jpeg(path, rng, size=256, block=32):
    """A seeded JPEG of size/block x size/block blocks of colour."""
    from PIL import Image

    low = rng.randint(0, 256, (size // block, size // block, 3))
    Image.fromarray(np.kron(low, np.ones((block, block, 1))).astype(
        np.uint8)).save(path, quality=90)


def _tie_distance(feat, src, dst, sim, het, ulps=64):
    """A slide's card graph (src, dst, sim as written) against `het`,
    built from the same features on the CPU: (the largest distance of a
    swapped neighbour from its row's k-th distance, over `ulps` f32 ulps
    of |q|^2 + |c|^2, which must be <= 1: lists differ only where
    neighbours tie within f32 rounding; sim max|err| over the edges both
    hold)."""
    e = int(np.asarray(het.edge_mask).sum())
    c_src, c_dst, c_sim = (np.asarray(a)[:e] for a in (het.src, het.dst,
                                                        het.sim))
    f = feat.astype(np.float64)
    sq = (f * f).sum(1)
    worst = sim_err = 0.0
    for i in np.unique(np.concatenate([src, c_src])):
        mine, theirs = dst[src == i], c_dst[c_src == i]
        a, b = dict(zip(mine, sim[src == i])), dict(zip(theirs,
                                                         c_sim[c_src == i]))
        for j in np.intersect1d(mine, theirs):
            sim_err = max(sim_err, abs(a[j] - b[j]))
        swapped = np.setxor1d(mine, theirs)
        if len(swapped):
            both = np.union1d(mine, theirs)
            d2 = sq[i] + sq[both] - 2.0 * f[both] @ f[i]
            kth = max(d2[np.isin(both, mine)].max(),
                      d2[np.isin(both, theirs)].max())
            tol = ulps * 2.0 ** -24 * (sq[i] + sq[swapped])
            worst = max(worst, float(
                (np.abs(d2[np.isin(both, swapped)] - kth) / tol).max()))
    return worst, sim_err


def test_construct_all_on_card_from_reference_weight_files(cuda, tmp_path):
    """BRCA_HovernetKimia_graph_constructor.yml, paths redirected, on the
    card over three seeded JPEG slides of 300-1000 patches, KimiaNet and HoVer-Net read from
    files under the reference's key names: one KNN a slide and the
    DenseNet and bn_act launches of every 128-patch chunk; slide 0's
    features within 1e-4 relative L2 of the encoder given the same
    weights as flax variables, node types equal; its graph the CPU's but
    where neighbours tie within f32 rounding, sims to 1e-5; `knn_impl:
    approx` writes every array the pallas build wrote; a GNNTrainer epoch
    reads the written files at the config's HEAT4 widths."""
    from wsi_hgnn_tpu_torch.graph.build import build_graph
    from wsi_hgnn_tpu_torch.models.featurizers import (HoVerNet, KimiaNet,
                                                       make_cnn_encoder)
    from wsi_hgnn_tpu_torch.models.featurizers import convert as keys
    from wsi_hgnn_tpu_torch.pipeline import (construct_all,
                                             iter_patch_batches, list_patches)

    sizes, rng = (300, 600, 1000), np.random.RandomState(40)
    names = [f"TCGA-XX-{9000 + i}-{'11A' if i == 0 else '01Z'}-00-DX1"
             for i in range(len(sizes))]
    for i, n in enumerate(sizes):
        d = tmp_path / "patches" / ("normal" if i == 0 else "tumor") / names[i]
        d.mkdir(parents=True)
        for j in range(n):
            _jpeg(d / f"{j:04d}_0.jpeg", rng)
    kimia, hover = (_seeded_tree(KimiaNet(), 11),
                    _seeded_tree(HoVerNet.typing(6, "fast"), 12))
    torch.save({k: torch.from_numpy(v) for k, v in
                keys.kimianet_state_dict(kimia).items()}, tmp_path / "k.pth")
    torch.save({"desc": {k: torch.from_numpy(v) for k, v in
                         keys.hovernet_state_dict(hover).items()}},
               tmp_path / "h.tar")
    cfg = load_config(CONSTRUCT_DIR / "BRCA_HovernetKimia_graph_constructor.yml")
    gcfg, hcfg, kcfg = (cfg["graph_constructor"], cfg["hovernet_config"],
                        cfg["kimianet_config"])
    assert (gcfg["encoder_name"], gcfg["knn_impl"], gcfg["radius"],
            gcfg["node_type_dir"], hcfg["batch_size"]) == (
        "kimia", "pallas", 9, None, 128)
    gcfg.update(patch_path=str(tmp_path / "patches") + "/",
                out_dir=str(tmp_path / "graphs"))
    hcfg["hovernet_model_path"] = str(tmp_path / "h.tar")
    kcfg["kimianet_model_path"] = str(tmp_path / "k.pth")
    kernels.reset_launch_counts()
    assert construct_all(gcfg, hcfg, kcfg, device=cuda) == len(sizes)
    chunks = sum(-(-n // 128) for n in sizes)
    assert kernels.launch_counts() == _counts(knn_l2_fused=len(sizes), **{
        k: v * chunks for k, v in PER_CHUNK.items()})

    out = tmp_path / "graphs"
    with np.load(out / "heterogeneous" / f"{names[0]}.npz") as z:
        feat, src, dst, sim = z["feat"], z["src"], z["dst"], z["sim"]
    types = np.load(out / "node_types" / f"{names[0]}.npy")
    enc = make_cnn_encoder("kimia", {"feature_dim": 1024, "n_node_type": 6},
                           hcfg, kcfg, with_typing=True, pad_batch_to=128,
                           device=cuda, kimia_variables=kimia,
                           hover_variables=hover)
    got = [enc(b) for b in iter_patch_batches(list_patches(
        tmp_path / "patches" / "normal" / names[0]), 128, out_dtype="uint8")]
    assert _rel_l2(torch.from_numpy(np.concatenate([g[0] for g in got])),
                   torch.from_numpy(feat)) <= 1e-4
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), types)
    worst, sim_err = _tie_distance(feat, src, dst, sim, build_graph(
        feat, types, 9, 6, knn_impl="pallas", device="cpu")[0])
    assert worst <= 1.0 and sim_err <= 1e-5

    approx = tmp_path / "approx_patches" / "normal"
    approx.mkdir(parents=True)
    (approx / names[0]).symlink_to(tmp_path / "patches" / "normal" / names[0])
    acfg = dict(gcfg, knn_impl="approx", patch_path=str(approx.parent) + "/",
                out_dir=str(tmp_path / "approx"))
    kernels.reset_launch_counts()
    assert construct_all(acfg, hcfg, kcfg, device=cuda) == 1
    assert kernels.launch_counts() == _counts(knn_l2_fused=1, **{
        k: v * -(-sizes[0] // 128) for k, v in PER_CHUNK.items()})
    for kind in ("heterogeneous", "homogeneous"):
        with np.load(out / kind / f"{names[0]}.npz") as a, np.load(
                tmp_path / "approx" / kind / f"{names[0]}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_array_equal(np.load(
        tmp_path / "approx" / "node_types" / f"{names[0]}.npy"), types)

    tcfg = load_config(HEAT4_BRCA)
    listing = tmp_path / "constructed.txt"
    listing.write_text("".join(f"{out / 'heterogeneous' / n}.npz\n"
                               for n in names))
    (tmp_path / "normal.txt").write_text(names[0][:16] + "\n")
    tcfg["datasets"].update(train_path=str(listing), valid_path=str(listing),
                            eval_path=str(listing),
                            normal_path=str(tmp_path / "normal.txt"))
    tcfg["train"]["num_epochs"] = 1
    tcfg["checkpoint"]["path"] = str(tmp_path / "ckpt")
    stats = GNNTrainer(tcfg, seed=611, device=cuda).train()
    assert stats["Epoch"] == 1 and np.isfinite(stats["Train Loss: "])


def test_make_hover_typing_equals_the_device_typing_on_card(cuda):
    """make_hover_typing (numpy in and out) on the card: int32 node types
    equal to make_hover_typing_device's on the same seeded patches."""
    from wsi_hgnn_tpu_torch.models.featurizers import (
        HoVerNet, make_hover_typing, make_hover_typing_device)

    hcfg, hover = {"mode": "fast"}, _seeded_tree(HoVerNet.typing(6, "fast"),
                                                 12)
    px = np.random.RandomState(60).randint(0, 256, (8, 256, 256, 3)
                                           ).astype(np.uint8)
    got = make_hover_typing(hcfg, 6, cuda, hover)(px)
    with torch.inference_mode():
        want = make_hover_typing_device(hcfg, 6, cuda, hover, 0)(
            torch.from_numpy(px).to(cuda).float() / 255.0)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want.cpu().numpy())


def test_profiling_trace_holds_the_knn_kernel_and_its_span(cuda, tmp_path):
    """profiling.trace around one KNN inside annotate('knn') and a device
    span 'knn': the trace file holds the KNN kernel among its device
    events and the annotation; the spans file beside it the span, once,
    with its card time and the card's idle time inside it."""
    import json

    from wsi_hgnn_tpu_torch import profiling
    from wsi_hgnn_tpu_torch.ops.knn import knn_lookup

    g = torch.randn(2048, 1024, device=cuda)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("knn"), profiling.span("knn", device=cuda):
            knn_lookup(g, 8)
            torch.cuda.synchronize()
    files = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and len(list(tmp_path.iterdir())) == 2
    events = json.loads(files[0].read_text())["traceEvents"]
    device = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    assert any("knn_l2" in name for name in device), device
    assert any(e.get("name") == "knn" for e in events)
    span = json.loads(Path(str(files[0]) + ".spans.json").read_text()
                      )["spans"]["knn"]
    assert span["count"] == 1 and span["device_s"] > 0
    assert 0 <= span["card_idle_s"] <= span["host_s"]


def _tissue_slide(path, w, h, seed=70):
    """A seeded slide image: white, with three overlapping ellipses of
    8 x 8-pixel colour blocks as tissue."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = np.kron(rng.randint(40, 230, (h // 8, w // 8, 3)),
                  np.ones((8, 8, 1))).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    tissue = np.zeros((h, w), bool)
    for cx, cy, rx, ry in ((0.33, 0.47, 0.34, 0.44), (0.69, 0.53, 0.31, 0.42),
                           (0.50, 0.22, 0.24, 0.18)):
        tissue |= (((xx - cx * w) / (rx * w)) ** 2
                   + ((yy - cy * h) / (ry * h)) ** 2) < 1
    img[~tissue] = 255
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path, quality=90)


@pytest.mark.parametrize("config", [
    "COAD_Hovernet_graph_constructor.yml",
    "BRCA_HovernetEfficient_graph_constructor.yml"])
def test_tiled_slide_constructs_on_card(cuda, tmp_path, monkeypatch,
                                        config):
    """A seeded 8192 x 6144 slide image tiled by `get_patches` (PIL,
    spawned workers), then built on the card with the config's encoder:
    'hover' (HoVer-Net with fc1 at 1024, seeded) or EfficientNet-B4 with
    inline typing, both from seeded weight files under the reference's
    names. Background tiles are dropped; one slide is written, its graph
    through the KNN kernel, with 1024-d finite features and k out-edges
    a node; the written bf16 features within 0.1 relative L2 of the
    CPU's f32 encoder on two of its patches."""
    from wsi_hgnn_tpu_torch import get_patches
    from wsi_hgnn_tpu_torch.models.featurizers import (
        EfficientNet, HoVerNet, efficientnet_apply, hovernet_full_apply,
        load_cnn_variables, make_hovernet)
    from wsi_hgnn_tpu_torch.models.featurizers import convert as keys
    from wsi_hgnn_tpu_torch.pipeline import (construct_all,
                                             iter_patch_batches, list_patches)

    slide = "TCGA-SY-0001-01Z-00-DX1"
    _tissue_slide(tmp_path / "data" / "SYN" / "tumor" / f"{slide}.jpeg",
                  8192, 6144)
    monkeypatch.chdir(tmp_path)
    out_base = get_patches.main(["-d", "SYN", "-v", "jpeg", "-b", "40", "-o",
                                 "40", "-j", "2", "-m", "0"])
    paths = list_patches(tmp_path / out_base / "tumor" / slide)
    assert 0 < len(paths) < 32 * 24
    cfg = load_config(CONSTRUCT_DIR / config)
    gcfg, hcfg, kcfg = (cfg["graph_constructor"], cfg["hovernet_config"],
                        cfg["kimianet_config"])
    name = gcfg["encoder_name"]
    assert (gcfg["knn_impl"], gcfg["radius"], gcfg["feature_dim"],
            hcfg["batch_size"]) == ("pallas", 9, 1024, 128)
    gcfg.update(patch_path=str(tmp_path / out_base) + "/",
                out_dir=str(tmp_path / "graphs"))
    if name == "hover":
        hcfg["hovernet_model_path"] = str(tmp_path / "absent.tar")
    else:
        assert name == "efficientnet-b4"
        torch.save({"desc": {k: torch.from_numpy(v) for k, v in
                             keys.hovernet_state_dict(_seeded_tree(
                                 HoVerNet.typing(6, "fast"), 31)).items()}},
                   tmp_path / "typing.tar")
        torch.save({k: torch.from_numpy(v) for k, v in
                    keys.efficientnet_state_dict(_seeded_tree(
                        EfficientNet.from_name(name, 1024), 32)).items()},
                   tmp_path / "eff.pth")
        hcfg["hovernet_model_path"] = str(tmp_path / "typing.tar")
        gcfg["efficientnet_model_path"] = str(tmp_path / "eff.pth")
    kernels.reset_launch_counts()
    assert construct_all(gcfg, hcfg, kcfg, device=cuda, verbose=False) == 1
    assert kernels.launch_counts()["knn_l2_fused"] >= 1
    with np.load(tmp_path / "graphs" / "heterogeneous" / f"{slide}.npz") as z:
        feat, n_edges = z["feat"], len(z["src"])
    assert feat.shape == (len(paths), 1024) and np.isfinite(feat).all()
    assert n_edges == len(paths) * 8

    x = torch.from_numpy(next(iter_patch_batches(
        paths[:2], 2, out_dtype="uint8"))).float() / 255.0
    with torch.inference_mode():
        if name == "hover":
            want = hovernet_full_apply(make_hovernet(
                hcfg, 6, cuda, feat_dim=1024).cpu(), x)[0]
        else:
            model = EfficientNet.from_name(name, 1024)
            convert.load_flax_variables(model, load_cnn_variables(
                "efficientnet", model, gcfg["efficientnet_model_path"], 0))
            want = efficientnet_apply(model.eval(), x)
    assert _rel_l2(torch.from_numpy(feat[:2]), want) <= 0.1


def _auc_allowance(labels, scores, err):
    """The AUC change that score errors up to `err` can make: the share
    of (tumour, other) patch pairs whose scores lie within 2 err."""
    labels, scores = np.asarray(labels), np.asarray(scores)
    pos, neg = scores[labels == 1], scores[labels == 0]
    return float((np.abs(pos[:, None] - neg[None, :]) <= 2 * err).mean())


def test_graph_explain_on_card_matches_cpu(cuda, tmp_path):
    """ExplainGraph.eval (what `main.py -mode graph_explain` runs) on the
    card over a Camelyon16-style layout: a 12 x 8-tile slide whose
    1024-d standardised features' graph the KNN kernel built, an
    annotation ellipse, HEAT4 at configs/BRCA/HEAT4_kimia_classification.yml's
    width from a version-1 checkpoint, its output layer scaled so the
    tumour logit trails by 3. One finite AUC, both heatmaps written, a
    score a patch; the scores within 1e-4 relative L2 of the CPU's and
    the AUCs equal but for the patch pairs the largest score difference
    can swap; a second explanation on the card gives the same AUC but
    for the pairs two card runs can swap. On a seeded 1024-node slide
    whose graphs the KNN kernel built, HetGemExplainer on that HEAT4 and
    GemExplainer on the BRCA GCN give a finite score a node."""
    import copy

    from PIL import Image

    from wsi_hgnn_tpu_torch.data import load_graph_npz
    from wsi_hgnn_tpu_torch.explain import (ExplainGraph, GemExplainer,
                                            HetGemExplainer)
    from wsi_hgnn_tpu_torch.graph.build import build_graph
    from wsi_hgnn_tpu_torch.graph.typed_graph import to_homogeneous
    from wsi_hgnn_tpu_torch.train.checkpoint import CheckpointManager
    from wsi_hgnn_tpu_torch.train.metrics import binary_auc_from_scores

    cols, rows, slide = 12, 8, "test_001"
    n, rng = cols * rows, np.random.RandomState(31)
    for d in ("patches/" + slide, "wsi", "annotations", "plots"):
        (tmp_path / d).mkdir(parents=True)
    for c in range(cols):
        for r in range(rows):
            (tmp_path / "patches" / slide / f"{c}_{r}.jpeg").touch()
    w, h = 256 * cols, 256 * rows
    Image.new("RGB", (w, h), (200, 120, 180)).save(
        tmp_path / "wsi" / f"{slide}.png")
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    (tmp_path / "annotations" / f"{slide}.xml").write_text(
        '<?xml version="1.0"?><ASAP_Annotations><Annotations><Annotation '
        'Name="Tumor" Type="Polygon"><Coordinates>' + "".join(
            f'<Coordinate Order="{i}" X="{(0.4 + 0.25 * np.cos(a)) * w:.2f}" '
            f'Y="{(0.45 + 0.3 * np.sin(a)) * h:.2f}"/>'
            for i, a in enumerate(t))
        + "</Coordinates></Annotation></Annotations></ASAP_Annotations>")
    (tmp_path / "reference.csv").write_text(f"NAME,LABEL\n{slide},Tumor\n")
    feat = rng.randn(n, 1024).astype(np.float32)
    types = rng.randint(0, 6, n)
    kernels.reset_launch_counts()
    het, _ = build_graph(feat, types, 9, 6, knn_impl="pallas", device=cuda)
    assert kernels.launch_counts()["knn_l2_fused"] == 1
    e = int(np.asarray(het.edge_mask).sum())
    save_graph_npz(tmp_path / f"{slide}.npz", feat, np.asarray(het.src)[:e],
                   np.asarray(het.dst)[:e], node_type=types,
                   esign=np.asarray(het.esign)[:e],
                   sim=np.asarray(het.sim)[:e], n_node_types=6)
    (tmp_path / "eval.txt").write_text(f"{tmp_path / slide}.npz\n")
    cfg = load_config(HEAT4_BRCA)
    assert cfg["eval"]["explainer_name"] == "GemExplainer"
    cfg["datasets"].update(
        dataset="C16", patches_path=str(tmp_path / "patches") + "/",
        wsi_path=str(tmp_path / "wsi") + "/",
        eval_path=str(tmp_path / "eval.txt"),
        reference_csv=str(tmp_path / "reference.csv"))
    cfg["checkpoint"]["path"] = str(tmp_path / "ckpt")
    cfg["eval"].update(explain_path=str(tmp_path / "plots") + "/",
                       annotation_path=str(tmp_path / "annotations") + "/",
                       patch_size=128)
    model, _ = parse_gnn_model(cfg["GNN"])
    convert.init_flax_like_(model, 9).eval()
    g = load_graph_npz(tmp_path / f"{slide}.npz").to_torch(
        torch.device("cpu"))
    with torch.no_grad():
        z = model(g.replace(esign=torch.ones_like(g.esign)))[0]
        model.head.weight.mul_(-3.0 / float(z[1] - z[0]))
        model.head.bias.mul_(-3.0 / float(z[1] - z[0]))
    variables = convert.to_flax_variables(model)
    CheckpointManager(cfg["checkpoint"]["path"]).write_new_version(
        cfg, {"params": variables["params"], "batch_stats": {}}, {"Epoch": 1})
    cpu_cfg = copy.deepcopy(cfg)
    cpu_cfg["GNN"]["typed_impl"] = "ragged"    # the same function
    cpu_cfg["eval"]["explain_path"] = str(tmp_path / "plots_cpu") + "/"
    eg, cpu = ExplainGraph(cfg, device=cuda), ExplainGraph(cpu_cfg,
                                                           device="cpu")
    auc, auc_cpu = eg.eval(), cpu.eval()
    s_dev, s_cpu = eg.last_scores[slide], cpu.last_scores[slide]
    assert len(auc) == 1 and np.isfinite(auc[0])
    for ext in (".png", ".jpeg"):
        assert (tmp_path / "plots" / f"{slide}{ext}").stat().st_size
    coords = eg.get_patch_coords(slide)
    labels, _ = eg.get_ground_truths(eg.eval_data.xml_paths[0], coords)
    assert len(coords) == n == len(s_dev) == len(s_cpu)
    assert np.isfinite(s_dev).all()
    assert 0 < sum(labels) < n
    assert np.linalg.norm(s_dev - s_cpu) <= 1e-4 * np.linalg.norm(s_cpu)
    assert abs(auc[0] - auc_cpu[0]) <= _auc_allowance(
        labels, s_cpu, np.abs(s_dev - s_cpu).max())
    graph, _, label = eg.eval_data[0]
    again = eg.explain_one(graph.to_torch(cuda), label)
    assert abs(binary_auc_from_scores(np.asarray(labels), again) - auc[0]) \
        <= _auc_allowance(labels, s_dev, np.abs(again - s_dev).max())

    gcn, _ = parse_gnn_model(load_config(
        ROOT / "configs/BRCA/GCN_kimia_classification.yml")["GNN"])
    gcn = convert.init_flax_like_(gcn, 4).to(cuda).eval()
    big = [torch.from_numpy(a).to(cuda) for a in (
        rng.randn(1, 1024, 1024).astype(np.float32),
        rng.randint(0, 6, (1, 1024)), np.ones((1, 1024), bool))]
    typed = build_batch_device(*big, 9, 6)
    homo = to_homogeneous(build_batch_device(*big, 9, 6,
                                             add_self_loops=True))
    assert kernels.launch_counts()["knn_l2_fused"] == 3
    for scores in (HetGemExplainer(typed, eg._model_fn, 1).flat_scores(),
                   GemExplainer(homo, lambda x: gcn(x), 1).explain_node()):
        assert len(scores) == 1024 and np.isfinite(scores).all()


@pytest.mark.parametrize("kind,flags", [
    ("abmil", []), ("dsmil", ["--remix-mode", "cov", "--num-prototypes", "1"]),
    ("gtn", ["--hidden", "64", "--clusters", "100"]), ("h2mil", [])])
def test_train_mil_folds_on_card(cuda, tmp_path, kind, flags):
    """`train_mil` on the card, 2 folds x 2 epochs over 12 seeded bags of
    800-1600 x 1024 (6 a class; gtn hidden 64 and 100 clusters, H2MIL at
    its defaults): every bag and class read, finite fold summaries, and
    no kernel launched (no bag model runs the KNN or a CNN)."""
    from wsi_hgnn_tpu_torch import train_mil

    rng = np.random.RandomState(3)
    rows = ["name,label"]
    for i in range(12):
        n = int(rng.randint(800, 1601))
        np.savez(tmp_path / f"bag{i}.npz", feat=(
            rng.randn(n, 1024) + 0.5 * (i % 2)).astype(np.float32))
        rows.append(f"bag{i},{i % 2}")
    (tmp_path / "labels.csv").write_text("\n".join(rows) + "\n")
    bags, labels, _, _ = train_mil.load_bags(str(tmp_path),
                                             str(tmp_path / "labels.csv"))
    assert len(bags) == 12 and np.bincount(labels).tolist() == [6, 6]
    kernels.reset_launch_counts()
    summary = train_mil.main(["--model", kind, "--feats-dir", str(tmp_path),
                              "--labels", str(tmp_path / "labels.csv"),
                              "--folds", "2", "--epochs", "2", *flags,
                              "--device", cuda.type])
    assert all(np.isfinite(summary[k]) for k in ("acc_mean", "f1_mean",
                                                 "auc_mean")), summary
    assert kernels.launch_counts() == _counts()


def test_train_mil_gigapath_folds_on_card(cuda, tmp_path, monkeypatch):
    """`train_mil --model gigapath` through its CLI on the card, at the
    published widths: 2 folds x 1 epoch over 12 seeded bags of 2048-8192
    tiles x 1536 with `xy` grid cells (6 a class): finite fold summaries,
    each fold's saved weights finite and moved from the seeded start, the
    bf16 evaluation's probabilities within 0.05 of the plain f32
    reference's (benchmark/reference/longnet.py) on the same weights, and
    no hand-written kernel launched."""
    from wsi_hgnn_tpu_torch import train_mil

    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    from reference import longnet as ref

    rng = np.random.RandomState(21)
    rows = ["name,label"]
    for i in range(12):
        n = int(rng.randint(2048, 8193))
        side = int(np.ceil(np.sqrt(n)))
        cells = rng.choice(side * side, n, replace=False)
        np.savez(tmp_path / f"bag{i}.npz", feat=(
            rng.randn(n, 1536) + 0.5 * (i % 2)).astype(np.float32),
            xy=np.stack([cells % side, cells // side], 1) + 100)
        rows.append(f"bag{i},{i % 2}")
    (tmp_path / "labels.csv").write_text("\n".join(rows) + "\n")
    kernels.reset_launch_counts()
    summary = train_mil.main(["--model", "gigapath", "--feats-dir",
                              str(tmp_path), "--labels",
                              str(tmp_path / "labels.csv"), "--folds", "2",
                              "--epochs", "1", "--save-dir",
                              str(tmp_path / "folds"), "--device", cuda.type])
    assert all(np.isfinite(summary[k]) for k in ("acc_mean", "f1_mean",
                                                 "auc_mean")), summary
    assert kernels.launch_counts() == _counts()
    bags, _, _, coords = train_mil.load_bags(str(tmp_path),
                                             str(tmp_path / "labels.csv"))
    pixels = train_mil.gigapath_coords(coords)
    start = train_mil.make_gigapath(1536, 2, cuda, 0).state_dict()
    for fold in range(2):
        sd = torch.load(tmp_path / "folds" / f"gigapath_fold{fold}.pt")
        assert all(torch.isfinite(v).all() for v in sd.values())
        assert not torch.equal(sd["patch_embed.proj.weight"],
                               start["patch_embed.proj.weight"])
        model = train_mil.make_gigapath(1536, 2, cuda, 0)
        model.load_state_dict(sd)
        for i in (0, 1):
            got = train_mil.gigapath_probs(model, bags[i], pixels[i], cuda)
            with torch.no_grad():
                want = torch.softmax(ref.logits(
                    sd, torch.from_numpy(bags[i]).to(cuda),
                    torch.from_numpy(pixels[i]).to(cuda), ref.ARCH),
                    -1)[0].cpu().numpy()
            assert abs(got.sum() - 1) < 1e-5
            assert np.abs(got - want).max() < 0.05, (fold, i, got, want)


def test_pretrain_simclr_and_extract_on_card(cuda, tmp_path):
    """tools.pretrain_simclr on the card (KimiaNet frozen) over 320 JPEG
    patches of 256 x 256 at its defaults (batch 64, so 128 views through
    the backbone), 2 epochs: 58 dense-layer and 3 transition launches a
    backbone forward and nothing else; --extract over 6 slide
    directories of 16 patches, one forward each, writes features within
    rtol 1e-3, atol 1e-4 of the checkpoint's KimiaNet module on the same
    images."""
    from wsi_hgnn_tpu_torch.tools import pretrain_simclr as tool

    rng = np.random.RandomState(90)
    for j in range(320):
        (tmp_path / "corpus" / f"c{j % 4}").mkdir(parents=True, exist_ok=True)
        _jpeg(tmp_path / "corpus" / f"c{j % 4}" / f"{j}.jpeg", rng)
    for i in range(6):
        (tmp_path / "slides" / f"sim{i}").mkdir(parents=True)
        for j in range(16):
            _jpeg(tmp_path / "slides" / f"sim{i}" / f"{j % 4}_{j // 4}.jpeg",
                  rng)
    kernels.reset_launch_counts()
    best = tool.main(["--patch-dir", str(tmp_path / "corpus"), "--out",
                      str(tmp_path / "run"), "--epochs", "2",
                      "--warmup-epochs", "1", "--device", cuda.type])
    forwards = 2 * ((320 - 64) // 64 + 64 // 64)   # train steps, val batches
    assert kernels.launch_counts() == _counts(
        dense_layer_fused=58 * forwards, transition_fused=3 * forwards)
    kernels.reset_launch_counts()
    tool.main(["--extract", "--ckpt", best, "--patch-dir",
               str(tmp_path / "slides"), "--out", str(tmp_path / "feats"),
               "--device", cuda.type])
    assert kernels.launch_counts() == _counts(dense_layer_fused=58 * 6,
                                              transition_fused=3 * 6)
    model, _ = tool.load_checkpoint(best, cuda)
    with np.load(tmp_path / "feats" / "sim0.npz") as z:
        got = torch.from_numpy(z["feat"]).to(cuda)
    imgs = tool.load_batch(sorted((tmp_path / "slides" / "sim0").glob(
        "*.jpeg")), 256)
    with torch.inference_mode():
        want = model(torch.from_numpy(imgs).to(cuda))[0]
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def _patches(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 256, 256, 3),
                                                dtype=np.uint8)


def test_sharded_encoders_over_a_repeated_card_match_one_device(cuda):
    """The 'kimia' (HoVer-Net typing inline) and 'hover' (fc1 width 1024)
    encoders sharded over (card, card) on a ragged chunk of 130 patches
    (padded to 256, 128 a device): two parts' DenseNet launches and two
    HoVer-Net forwards' bn_act launches a part, and the slide graph's one
    KNN; features within 1e-3 relative L2 and node types equal to the
    single-device encoder's on the same per-device batches, and within
    the bf16 bound 0.1 of its answer on the whole chunk; the graph holds
    every patch."""
    from wsi_hgnn_tpu_torch.graph.build import build_graph
    from wsi_hgnn_tpu_torch.models.featurizers import (_pad_rows,
                                                       make_cnn_encoder)

    px, chunk = _patches(130, 90), 128
    enc = {(name, sharded): make_cnn_encoder(
        name, {"feature_dim": 1024, "n_node_type": 6},
        {"mode": "fast", "batch_size": chunk}, {},
        with_typing=name == "kimia", pad_batch_to=chunk, device=cuda,
        devices=[cuda, cuda] if sharded else None)
        for name in ("kimia", "hover") for sharded in (True, False)}
    kernels.reset_launch_counts()
    got = {name: enc[name, True](px) for name in ("kimia", "hover")}
    het, _ = build_graph(*got["kimia"], radius=9, n_node_types=6,
                         knn_impl="pallas", device=cuda)
    assert kernels.launch_counts() == _counts(
        knn_l2_fused=1, dense_layer_fused=58 * 2, transition_fused=3 * 2,
        bn_act=2 * 76 * 2)
    assert int(np.asarray(het.node_mask).sum()) == 130
    halves = _pad_rows(px, 2 * chunk).reshape(2, chunk, 256, 256, 3)
    for name in ("kimia", "hover"):
        parts = [enc[name, False](half) for half in halves]
        f, t = got[name]
        assert f.shape == (130, 1024) and np.isfinite(f).all()
        want = torch.from_numpy(np.concatenate([p[0] for p in parts])[:130])
        assert float((torch.from_numpy(f) - want).norm()
                     / want.norm()) <= 1e-3
        np.testing.assert_array_equal(
            t, np.concatenate([p[1] for p in parts])[:130])
        whole = torch.from_numpy(enc[name, False](px)[0])
        assert float((torch.from_numpy(f) - whole).norm()
                     / whole.norm()) <= 0.1


def test_sharded_steps_on_one_card_match_the_single_card_step(cuda,
                                                              tmp_path):
    """Edge sharding and data parallelism with every rank on the one
    card: a gloo world of 2 runs the edge-sharded HEAT4 and GCN steps at
    their BRCA configs' widths (each rank half of two 1024-node slides'
    edge store, in_dim 1024) and the data-parallel GCN step (a slide a
    rank); an NCCL world of 1 in this process the edge-sharded HEAT4
    step. The slides' graphs are the KNN kernel's; the ranks' losses
    agree to 1e-5 relative, and every rank's gradients pass the float64
    judge against the single-card step."""
    import socket
    import types as pytypes

    import torch.distributed as dist

    import port_worlds
    from wsi_hgnn_tpu_torch.graph.typed_graph import to_homogeneous
    from wsi_hgnn_tpu_torch.parallel import (local_edges,
                                             make_big_graph_train_step,
                                             make_mesh)

    rng, nodes = np.random.RandomState(91), 1024
    kernels.reset_launch_counts()
    g = build_batch_device(
        torch.from_numpy(rng.randn(2, nodes, 1024).astype(np.float32)
                         ).to(cuda),
        torch.from_numpy(rng.randint(0, 6, (2, nodes))).to(cuda),
        torch.ones((2, nodes), dtype=torch.bool, device=cuda), 9, 6)
    assert kernels.launch_counts() == _counts(knn_l2_fused=2)
    gnn = {"HEAT4": dict(load_config(BRCA["HEAT4"][0])["GNN"], feat_drop=0.0),
           "GCN": dict(load_config(BRCA["GCN"][0])["GNN"], feat_drop=0.0,
                       dropout=0.0)}
    variables = {"HEAT4": _seeded_tree(parse_gnn_model(gnn["HEAT4"])[0], 5),
                 "GCN": _seeded_tree(parse_gnn_model(gnn["GCN"])[0], 6)}
    arrays = port_worlds.device_graph_arrays(g)
    ranks = port_worlds.run_world(port_worlds.card_steps, 2, tmp_path, {
        "gnn": gnn, "variables": variables, "labels": np.array([0, 1]),
        "graph": arrays, "slides": [port_worlds.slide_arrays(arrays, r, nodes)
                                    for r in range(2)]}, device="cuda")
    loss_fcn, y = parse_loss({"loss": "CE"}), torch.tensor([0, 1])

    def single_step(name):
        """The single-card step's model and its float64 runner."""
        def run(m, dev):
            gd = port_worlds.host_graph(arrays).to_torch(dev)
            gd = gd if name == "HEAT4" else to_homogeneous(gd)
            dtype = next(m.parameters()).dtype
            gd = gd.replace(feat=gd.feat.to(dtype), sim=gd.sim.to(dtype))
            m.train()
            m.zero_grad(set_to_none=False)
            loss_fcn(m(gd), y.to(dev), torch.ones(2, dtype=dtype,
                                                  device=dev)).backward()

        def run64(m, dev):
            with gradcheck.float64_default():
                run(m, dev)

        ref = port_worlds.port_model(gnn[name], variables[name]).to(cuda)
        run(ref, cuda)
        return ref, run64, port_worlds.port_model(
            gnn[name], variables[name]).double()

    def judged(name, grads):
        ref, run64, base64 = refs[name]
        got = [(n, pytypes.SimpleNamespace(grad=torch.as_tensor(grads[n]),
                                           requires_grad=True))
               for n, _ in ref.named_parameters()]
        text, failed, _ = judge_grads(list(ref.named_parameters()), got,
                                      run64, base64, cuda)
        assert not failed, (name, failed, text)

    refs = {name: single_step(name) for name in gnn}
    for key, name in (("HEAT4", "HEAT4"), ("GCN", "GCN"), ("dp", "GCN")):
        losses = [r[key][0] for r in ranks]
        assert np.isfinite(losses).all()
        assert max(losses) - min(losses) <= 1e-5 * abs(losses[0])
        for r in ranks:
            judged(name, r[key][1])

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh(device=cuda)
        model = port_worlds.port_model(gnn["HEAT4"],
                                       variables["HEAT4"]).to(cuda)
        make_big_graph_train_step(
            model, torch.optim.SGD(model.parameters(), lr=1e-3), loss_fcn,
            True, mesh, augment=False)(
            local_edges(port_worlds.host_graph(arrays), mesh), y.to(cuda),
            torch.ones(2, device=cuda),
            torch.Generator(device=cuda).manual_seed(0))
    finally:
        dist.destroy_process_group()
    judged("HEAT4", {n: p.grad for n, p in model.named_parameters()})


def test_gigapath_steps_on_card_match_the_f32_reference(cuda, monkeypatch):
    """Prov-GigaPath's slide encoder at its published widths through
    train_mil's gigapath step (bf16 autocast, fused AdamW) on one
    8192-tile bag of the benchmark's cohort, three steps, against the
    plain f32 reference's (benchmark/reference/longnet.py) from the same
    seeded weights: grad_gap and change_gap, over the leaves the cell
    compares, within the gigapath-train cell's limits (loss_gap is
    printed: the cell reads it with no limit)."""
    from wsi_hgnn_tpu_torch import train_mil

    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    from common import Ctx
    from reference import longnet as ref
    from run import load_cell
    from traffic import mil_epochs
    from traffic.train_epochs import BETA1, compare

    workload, cfg = load_cell("gigapath-train")
    workload = copy.deepcopy(workload)
    workload["params"].update(slides=1, min_tiles=8192, max_tiles=8192)
    ctx = Ctx(cell="gigapath-train", workload=workload, config=cfg, seed=77,
              seconds=0.0, trace=False, device=cuda, t_start=0.0)
    arch = ref.arch_of(cfg)
    feats, cells, labels, _ = mil_epochs.make_cohort(ctx, arch)
    coords = train_mil.gigapath_coords(cells)
    w = ref.make_weights(ref.spec(arch), 78, cuda)
    model = train_mil.make_gigapath(arch["in_dim"], arch["n_classes"], cuda,
                                    **mil_epochs.model_sizes(arch, cfg))
    model.load_state_dict(w)
    opt_cfg = {k: float(cfg["optimizer"][k])
               for k in ("lr", "weight_decay", "layer_decay")}
    opt = train_mil.gigapath_optimizer(model, cuda, **opt_cfg)
    named = dict(model.named_parameters())
    losses = []
    for s in range(3):
        losses.append(float(train_mil.gigapath_train_step(
            model, opt, feats[0], coords[0], int(labels[0]), cuda)))
        if s == 0:
            adam1 = {f"params/{k}": opt.state[v]["exp_avg"] / (1 - BETA1)
                     for k, v in named.items()}
    after = {f"params/{k}": v.detach() for k, v in named.items()}
    want = mil_epochs.reference_leaves(ref.reference_steps(
        w, [(feats[0], coords[0], labels[0])] * 3, arch, opt_cfg, cuda))
    gaps = compare(losses, adam1, after, {"params": w}, want)
    print("gigapath bf16 against f32:", gaps)
    for name, limit in workload["limits"].items():
        assert gaps[name] <= limit, (name, gaps[name])
