"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the serving path on the card
against the CPU path.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one, so every process collects the same tests. The module
imports no JAX (the machine with the card has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from wsi_hgnn_tpu_torch import convert, kernels
from wsi_hgnn_tpu_torch.config import parse_lattice_twin
from wsi_hgnn_tpu_torch.kernels import densenet as kdn
from wsi_hgnn_tpu_torch.kernels import knn as kknn
from wsi_hgnn_tpu_torch.models.featurizers import (KimiaNet, fuse_kimianet,
                                                   kimianet_fused_apply)
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.utils import set_cuda_numerics

pytestmark = pytest.mark.gpu

# f32: summation order only; bf16: outputs carry 8 mantissa bits and the
# bottleneck is rounded to bf16 before the 3x3 conv
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_cuda_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("n", [384, 700])
def test_knn_kernel_equals_plain_on_exact_data(cuda, n):
    """Small-integer features make every distance exact in f32, so the
    kernel must equal the plain version bit for bit, planted ties and a
    ragged N (700 is no multiple of the kernel's tiles) included."""
    rng = np.random.RandomState(0)
    f = rng.randint(-8, 9, (n, 96)).astype(np.float32)
    f[1::6] = f[0:n - 1:6][: len(f[1::6])]
    x = torch.from_numpy(f).to(cuda)
    mask = torch.arange(n, device=cuda) < n - 50
    before = kknn.knn_l2_fused.launches
    i_k, d_k = kknn.knn_l2_fused(x, 8, mask)
    i_p, d_p = kknn.knn_l2_reference(x, 8, mask)
    torch.cuda.synchronize()
    assert kknn.knn_l2_fused.launches == before + 1
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


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
@pytest.mark.parametrize("h,k_in", [(16, 160), (12, 64), (8, 224)])
def test_dense_layer_kernel_matches_plain(cuda, dtype, h, k_in):
    """In place: the prefix is untouched, the slot matches the plain
    version, the channels past the slot stay 0. H=12 leaves a ragged
    8x8 output tile."""
    ops = _layer(cuda, dtype, h=h, k_in=k_in)
    kw = dict(n_active_groups=-(-k_in // 128), slot=k_in // 32)
    got = kdn.dense_layer_fused(ops[0].clone(), *ops[1:], **kw)
    want = kdn.dense_layer_reference(ops[0].clone(), *ops[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[..., :k_in], ops[0][..., :k_in])
    assert not got[..., k_in + 32:].any()
    torch.testing.assert_close(got[..., k_in:k_in + 32].float(),
                               want[..., k_in:k_in + 32].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", [(8, 64), (16, 256), (6, 320)])
def test_transition_kernel_matches_plain(cuda, dtype, h, c):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, h, h, c, generator=g).to(cuda, dtype)
    a = (torch.rand(1, c, generator=g) + 0.5).to(cuda)
    b = (torch.randn(1, c, generator=g) * 0.1).to(cuda)
    w = (torch.randn(c, c // 2, generator=g) * (2.0 / c) ** 0.5).to(cuda, dtype)
    torch.testing.assert_close(kdn.transition_fused(x, a, b, w).float(),
                               kdn.transition_reference(x, a, b, w).float(),
                               **TOL[dtype])
    out = torch.zeros(3, h // 2, h // 2, c // 2 + 32, dtype=dtype, device=cuda)
    kdn.transition_fused(x, a, b, w, out=out)
    torch.testing.assert_close(out[..., :c // 2].float(),
                               kdn.transition_reference(x, a, b, w).float(),
                               **TOL[dtype])
    assert not out[..., c // 2:].any()


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
