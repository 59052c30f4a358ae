"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the serving and training paths on
the card against the CPU path.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one, so every process collects the same tests. The module
imports no JAX (the machine with the card has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from wsi_hgnn_tpu_torch import convert, kernels
from wsi_hgnn_tpu_torch.config import (parse_gnn_model, parse_lattice_twin,
                                       parse_loss, parse_optimizer)
from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz
from wsi_hgnn_tpu_torch.graph import (batch_graphs, from_arrays,
                                      sort_graph_edges, transforms)
from wsi_hgnn_tpu_torch.graph import ops as gops
from wsi_hgnn_tpu_torch.models import DropSource
from wsi_hgnn_tpu_torch.kernels import densenet as kdn
from wsi_hgnn_tpu_torch.kernels import knn as kknn
from wsi_hgnn_tpu_torch.models import lattice as tlat
from wsi_hgnn_tpu_torch.models.featurizers import (KimiaNet, fuse_kimianet,
                                                   kimianet_fused_apply)
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.train import (GNNTrainer, HomoGraphEvaluator,
                                      lattice_train_step, typed_train_step)
from wsi_hgnn_tpu_torch.utils import set_cuda_numerics
import port_threads  # noqa: F401  (torch threads per test worker)

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


# card vs CPU gradients of one step, per parameter tensor: relative L2
# error within GRAD_RTOL, or, where the f32 arithmetic explains the miss,
# ||g_card - g_64|| <= GRAD_F32 ||g_cpu - g_64|| + GRAD_NOISE G_64 against
# the same step in float64 (chip_smoke.py grad_check)
GRAD_RTOL, GRAD_F32, GRAD_NOISE = 1e-4, 3.0, 1e-6


def assert_grads_match(named_cpu, named_dev, named_f64):
    """Every parameter's `.grad` after one step on the card against the
    CPU's (see GRAD_RTOL, GRAD_F32, GRAD_NOISE), and a CPU gradient that
    is exactly zero (a dead layer) exactly zero on the card."""
    rows = [(name, p32.grad.double(), pd.grad.cpu().double(), p64.grad)
            for (name, p32), (_, pd), (_, p64) in zip(
                named_cpu, named_dev, named_f64)]
    noise = GRAD_NOISE * max(float(g64.norm()) for *_, g64 in rows)
    for name, g32, gd, g64 in rows:
        den = float(g32.norm())
        if den == 0.0:
            assert not gd.any(), name
        elif float((gd - g32).norm()) > GRAD_RTOL * den:
            bound = GRAD_F32 * float((g32 - g64).norm()) + noise
            assert float((gd - g64).norm()) <= bound, name


class _Float64Default:
    def __enter__(self):
        self.old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)

    def __exit__(self, *exc):
        torch.set_default_dtype(self.old)


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
    m64 = convert.init_flax_like_(parse_lattice_twin(SMALL_GNN), seed=0)
    m64.double()
    with _Float64Default():
        lattice_train_step(
            m64, parse_optimizer(optim, m64.parameters()), loss_fn,
            g_cpu._replace(feats=g_cpu.feats.double(), sim=g_cpu.sim.double()),
            labels, weights.double(), masks=masks, drop_masks=drops)
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
                       m64.named_parameters())


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
    L2 (dead layers' zeros exactly), running statistics to 1e-4."""
    model, is_hetero = parse_gnn_model(ZOO[family])
    convert.init_flax_like_(model, seed=0)
    host = _typed_batch(is_hetero)
    optim = {"opt_method": "ADAM", "lr": 1e-3, "weight_decay": 5e-3}
    loss_fn = parse_loss({"loss": "CE"})
    labels, weights = torch.tensor([0, 1]), torch.tensor([1.0, 1.0])
    gen = torch.Generator().manual_seed(1)
    g_cpu = host.to_torch(torch.device("cpu"))
    masks = transforms.draw_train_masks(g_cpu, gen)
    drops = DropSource(gen)
    card = convert.init_flax_like_(parse_gnn_model(ZOO[family])[0],
                                   seed=0).to(cuda)
    m64 = convert.init_flax_like_(parse_gnn_model(ZOO[family])[0], seed=0)
    m64.double()
    res = []
    for dev, m, src in ((torch.device("cpu"), model, drops),
                        (cuda, card, None)):
        if src is None:
            src = DropSource(masks=[a.to(dev) for a in drops.used])
        loss, prob = typed_train_step(
            m, parse_optimizer(optim, m.parameters()), loss_fn,
            host.to_torch(dev), labels.to(dev), weights.to(dev), is_hetero,
            masks=transforms.TrainMasks(*(a.to(dev) for a in masks)),
            drops=src)
        res.append((float(loss), prob.cpu(), m))
    g64 = host.to_torch(torch.device("cpu"))
    with _Float64Default():
        typed_train_step(
            m64, parse_optimizer(optim, m64.parameters()), loss_fn,
            g64.replace(feat=g64.feat.double(), sim=g64.sim.double()),
            labels, weights.double(), is_hetero, masks=masks,
            drops=DropSource(masks=drops.used))
    (l_cpu, p_cpu, m_cpu), (l_dev, p_dev, m_dev) = res
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    torch.testing.assert_close(p_dev, p_cpu, rtol=1e-5, atol=1e-5)
    assert_grads_match(m_cpu.named_parameters(), m_dev.named_parameters(),
                       m64.named_parameters())
    v_cpu, v_dev = (convert.to_flax_variables(m) for m in (m_cpu, m_dev))
    for key, a in _flat(v_dev.get("batch_stats", {})).items():
        assert np.abs(a - _flat(v_cpu["batch_stats"])[key]).max() <= 1e-4, key


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
