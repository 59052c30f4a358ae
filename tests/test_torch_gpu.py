"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the serving and training paths on
the card against the CPU path.

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
    model = convert.init_flax_like_(parse_lattice_twin(SMALL_GNN), seed=0)
    gen = torch.Generator().manual_seed(1)
    masks = tlat.draw_train_masks(g_cpu, gen)
    drops = model.draw_dropout_masks(g_cpu, gen)
    optim = {"opt_method": "ADAM", "lr": 1e-3, "weight_decay": 5e-3}
    loss_fn = parse_loss({"loss": "CE"})
    labels, weights = torch.tensor([0, 1]), torch.tensor([1.0, 1.0])
    res = []
    base64 = convert.init_flax_like_(parse_lattice_twin(SMALL_GNN), seed=0)
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
                       parse_lattice_twin(SMALL_GNN), seed=0).to(cuda))):
        loss, prob = lattice_train_step(
            m, parse_optimizer(optim, m.parameters()), loss_fn,
            tlat.LatticeGraph(*(a.to(dev) for a in g_cpu)), labels.to(dev),
            weights.to(dev), masks=tlat.TrainMasks(*(a.to(dev) for a in masks)),
            drop_masks=[a.to(dev) for a in drops])
        res.append((float(loss), prob.cpu(), m))
    (l_cpu, p_cpu, m_cpu), (l_dev, p_dev, m_dev) = res
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    torch.testing.assert_close(p_dev, p_cpu, rtol=1e-5, atol=1e-6)
    assert_grads_match(m_cpu.named_parameters(), m_dev.named_parameters(),
                       run64, base64, cuda)


def test_trainer_one_epoch_on_card(cuda, tmp_path):
    """The whole lattice trainer for one epoch on 4 slides whose graphs
    were built on the card, then the evaluator on its checkpoint on the
    card and on the CPU."""
    rng = np.random.RandomState(2)
    paths, normals = [], []
    for i in range(4):
        n = int(rng.randint(200, 500))
        feat = (rng.randn(n, 32) + 0.5 * (i % 2)).astype(np.float32)
        types = rng.randint(0, 6, n).astype(np.int32)
        before = kknn.knn_l2_fused.launches
        g = tlat.build_lattice_device(
            torch.from_numpy(feat[None]).to(cuda),
            torch.from_numpy(types[None]).to(cuda),
            torch.ones(1, n, dtype=torch.bool, device=cuda), 9, 6)
        assert kknn.knn_l2_fused.launches == before + 1
        barcode = f"TCGA-XX-{i:04d}-01Z-00-DX1"
        paths.append(str(tmp_path / f"{barcode}.npz"))
        save_graph_npz(paths[-1], feat, np.repeat(np.arange(n), 8),
                       g.idx[0].reshape(-1).cpu().numpy(), node_type=types,
                       esign=g.esign[0].reshape(-1).cpu().numpy(),
                       sim=g.sim[0].reshape(-1).cpu().numpy())
        if i % 2 == 0:
            normals.append(barcode[:16])
    (tmp_path / "split.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "normal.txt").write_text("\n".join(normals) + "\n")
    split = str(tmp_path / "split.txt")
    cfg = {"datasets": {"dataset": "BRCA", "task": "cancer classification",
                        "train_path": split, "eval_path": split,
                        "valid_path": split,
                        "normal_path": str(tmp_path / "normal.txt")},
           "checkpoint": {"path": str(tmp_path / "ckpt")},
           "optimizer": {"opt_method": "ADAM", "lr": 1e-3,
                         "weight_decay": 5e-3},
           "GNN": dict(SMALL_GNN),
           "train": {"num_epochs": 1, "batch_size": 2, "loss": "CE"}}
    stats = GNNTrainer(cfg, seed=0, device=cuda).train()
    assert stats["Epoch"] == 1 and np.isfinite(stats["Train Loss: "])
    assert (tmp_path / "ckpt" / "model_v1.msgpack").exists()
    on_card = HomoGraphEvaluator(cfg, verbose=False, device=cuda)
    on_cpu = HomoGraphEvaluator(cfg, verbose=False, device="cpu")
    np.testing.assert_allclose(on_card.eval(), on_cpu.eval(), atol=1e-6)
    np.testing.assert_allclose(on_card.last_metrics["prob"],
                               on_cpu.last_metrics["prob"], atol=1e-4)


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


@pytest.mark.parametrize("family", ["GCN", "HGT"])
def test_typed_predictor_on_card_launches_the_knn_per_slide(cuda, family):
    """SlidePredictor's TypedGraph path on the card builds each slide's
    graph through the KNN kernel (one launch per slide) and answers as
    the CPU path does."""
    gnn = dict(ZOO[family], in_dim=64)
    model, _ = parse_gnn_model(gnn)
    variables = convert.to_flax_variables(convert.init_flax_like_(model, 0))
    rng = np.random.RandomState(3)
    slides = [(rng.randn(n, 64).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32)) for n in (300, 41, 700)]
    on_card = SlidePredictor({"GNN": gnn}, variables=variables, device=cuda)
    on_cpu = SlidePredictor({"GNN": gnn}, variables=variables, device="cpu")
    assert not on_card.uses_lattice(3, 768)
    before = kknn.knn_l2_fused.launches
    got = on_card.predict_many(slides)
    assert kknn.knn_l2_fused.launches == before + 3
    np.testing.assert_allclose(got, on_cpu.predict_many(slides), atol=1e-4)


def test_server_round_trip_on_card(cuda):
    """BatchingServer over a predictor on the card: concurrent feature
    requests (grouped and padded to max_batch) answer as the CPU
    predictor answers each slide alone, one KNN launch per padded slide,
    and /healthz reports no version for given variables."""
    import io
    import json
    import threading
    import urllib.request

    from wsi_hgnn_tpu_torch.serve import BatchingServer

    gnn = dict(ZOO["HEAT4"], in_dim=64)
    model = parse_lattice_twin(gnn)
    variables = convert.to_flax_variables(convert.init_flax_like_(model, 0))
    on_card = SlidePredictor({"GNN": gnn}, variables=variables, device=cuda)
    on_cpu = SlidePredictor({"GNN": gnn}, variables=variables, device="cpu")
    rng = np.random.RandomState(5)
    slides = [(rng.randn(n, 64).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32))
              for n in (300, 280, 700, 650, 41)]
    results = [None] * len(slides)
    server = BatchingServer(on_card, max_batch=4, max_wait_ms=500.0)
    server.start()
    try:
        def post(i):
            buf = io.BytesIO()
            np.savez(buf, features=slides[i][0], node_types=slides[i][1])
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/predict",
                data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = json.loads(r.read())

        before = kknn.knn_l2_fused.launches
        threads = [threading.Thread(target=post, args=(i,), daemon=True)
                   for i in range(len(slides))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["model_version"] is None
    finally:
        server.stop()
    assert stats["requests"] == 5 and stats["errors"] == 0
    assert kknn.knn_l2_fused.launches - before == 4 * stats["batches"]
    for s, r in zip(slides, results):
        np.testing.assert_allclose(r["probs"], on_cpu.predict(*s), atol=1e-4)


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


@pytest.mark.parametrize("kind", ["abmil", "dsmil", "gtn"])
def test_mil_step_on_card_matches_cpu(cuda, kind):
    """One train_mil step of each bag model on the card against the CPU:
    loss to 1e-5 relative, gradients by assert_grads_match."""
    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models import mil

    rng = np.random.RandomState(5)
    d, n, cap = 64, 300, 320
    feats, mask = mil.pad_bag(rng.randn(n, d).astype(np.float32),
                              capacity=cap)
    if kind == "gtn":
        model = mil.GraphTransformer(2, d, 32, 16)
        edges = mil.spatial_adjacency(
            [tuple(c) for c in train_mil.grid_coords(n)])
    else:
        model = (mil.ABMIL if kind == "abmil" else mil.DSMIL)(2, d)
    convert.init_flax_like_(model, seed=1)
    base64 = copy.deepcopy(model).double()

    def step(m, dev, dtype=torch.float32):
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
            step(m, dev, torch.float64)

    m_cpu, m_dev = copy.deepcopy(model), copy.deepcopy(model).to(cuda)
    l_cpu = float(step(m_cpu, torch.device("cpu")))
    l_dev = float(step(m_dev, cuda))
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    assert_grads_match(m_cpu.named_parameters(), m_dev.named_parameters(),
                       run64, base64, cuda)


def test_h2mil_step_on_card_matches_cpu(cuda):
    """One H2MIL train_mil step (dropout off, so both devices compute one
    function) on the card against the CPU: loss to 1e-5 relative,
    gradients by assert_grads_match; IHPool's weights, which no gradient
    reaches, exactly 0 on both."""
    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models.mil import H2MIL
    from wsi_hgnn_tpu_torch.models.mil.h2mil import (build_tree_graph,
                                                     tree_to_torch)

    rng = np.random.RandomState(6)
    d, n = 64, 300
    tree = build_tree_graph(rng.randn(n, d).astype(np.float32),
                            train_mil.grid_coords(n), cell=4)
    model = convert.init_flax_like_(H2MIL(d, 32, 2, dropout=0.0), seed=2)
    base64 = copy.deepcopy(model).double()

    def step(m, dev, dtype=torch.float32):
        opt = torch.optim.Adam(m.parameters(), lr=2e-4, weight_decay=5e-4)
        return train_mil.h2mil_train_step(m, opt,
                                          tree_to_torch(tree, dev, dtype), 1)

    def run64(m, dev):
        with gradcheck.float64_default():
            step(m, dev, torch.float64)

    m_cpu, m_dev = copy.deepcopy(model), copy.deepcopy(model).to(cuda)
    l_cpu = float(step(m_cpu, torch.device("cpu")))
    l_dev = float(step(m_dev, cuda))
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    assert not m_dev.pool_1.weight_1.grad.any()
    assert_grads_match(m_cpu.named_parameters(), m_dev.named_parameters(),
                       run64, base64, cuda)


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
                                       "bn_act": 0}
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_graphcam_on_card_matches_cpu(cuda):
    """GraphCAM of every class on the card against the CPU: within 1e-4
    relative plus an atol of 3x the spread of randomly rounded float64
    runs (gradcheck.output_spread), as the explanation scores are judged;
    a sign-flipped cam fails that check."""
    from wsi_hgnn_tpu_torch import train_mil
    from wsi_hgnn_tpu_torch.models import mil

    rng = np.random.RandomState(7)
    d, n, cap = 64, 300, 320
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
        assert not np.all(np.abs(-got - want) <= atol + 1e-4 * np.abs(want))


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
