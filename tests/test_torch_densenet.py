"""Port parity: DenseNet kernels' plain versions and KimiaNet
(wsi_hgnn_tpu_torch/kernels/densenet.py, models/featurizers/densenet.py)
against the JAX package's Pallas kernels (interpret mode) and flax
KimiaNet, on the CPU, plus the weight bridge."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.models.featurizers import densenet as jdn
from wsi_hgnn_tpu.ops import pallas_densenet as jpd
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.kernels import densenet as tdn
from wsi_hgnn_tpu_torch.models.featurizers import densenet as tfd
import port_threads  # noqa: F401  (torch threads per test worker)


def _layer_inputs(c_cur, c_end=256, b=2, h=16, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros((b, h, h, c_end), np.float32)
    x[..., :c_cur] = rng.randn(b, h, h, c_cur)
    a1 = np.zeros((1, c_end), np.float32)
    b1 = np.zeros((1, c_end), np.float32)
    a1[0, :c_cur] = rng.rand(c_cur) + 0.5
    b1[0, :c_cur] = rng.randn(c_cur) * 0.1
    w1f = np.zeros((c_end, 128), np.float32)
    w1f[:c_cur] = rng.randn(c_cur, 128) * 0.05
    b2 = (rng.randn(1, 128) * 0.1).astype(np.float32)
    w2cat = (rng.randn(128, 288) * 0.05).astype(np.float32)
    return x, a1, b1, w1f, b2, w2cat


@pytest.mark.parametrize("c_cur", [160, 128, 64])
def test_dense_layer_matches_pallas_f32(c_cur):
    """160: a partly written 128-group; 128: a fresh group; 64: the first
    layer of block 1. In place: prefix untouched, slot written, tail 0."""
    ops = _layer_inputs(c_cur)
    kw = dict(n_active_groups=-(-c_cur // 128), slot=c_cur // 32)
    want = np.asarray(jpd.dense_layer_fused(
        *[jnp.asarray(a) for a in ops], interpret=True, **kw))
    x = torch.from_numpy(ops[0].copy())
    out = tdn.dense_layer_fused(x, *[torch.from_numpy(a) for a in ops[1:]],
                                **kw)
    assert out is x  # updated in place
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out.numpy()[..., :c_cur], ops[0][..., :c_cur])
    assert not out.numpy()[..., c_cur + 32:].any()


def test_dense_layer_matches_pallas_bf16():
    """bf16 storage. The TPU kernel also rounds the 3x3 conv's tap
    products to bf16 before summing them (pallas_densenet.py:72) and the
    port does not, so the outputs may differ by a few bf16 ulps (2^-8
    relative each): rtol/atol 3e-2."""
    ops = _layer_inputs(160, seed=1)
    kw = dict(n_active_groups=2, slot=5)
    bf = [ops[0].astype(jnp.bfloat16), ops[1], ops[2],
          ops[3].astype(jnp.bfloat16), ops[4], ops[5].astype(jnp.bfloat16)]
    want = np.asarray(jpd.dense_layer_fused(
        *[jnp.asarray(a) for a in bf], interpret=True, **kw)).astype(np.float32)
    tt = [torch.from_numpy(a) for a in ops]
    for i in (0, 3, 5):
        tt[i] = tt[i].to(torch.bfloat16)
    out = tdn.dense_layer_fused(*tt, **kw).float().numpy()
    np.testing.assert_allclose(out[..., 160:192], want[..., 160:192],
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("h,c", [(8, 64), (4, 256)])
def test_transition_matches_pallas_f32(h, c):
    rng = np.random.RandomState(2)
    x = rng.randn(2, h, h, c).astype(np.float32)
    a = (rng.rand(1, c) + 0.5).astype(np.float32)
    b = (rng.randn(1, c) * 0.1).astype(np.float32)
    w = (rng.randn(c, c // 2) * 0.05).astype(np.float32)
    want = np.asarray(jpd.transition_fused(*[jnp.asarray(v) for v in (x, a, b, w)],
                                           interpret=True))
    got = tdn.transition_fused(*[torch.from_numpy(v) for v in (x, a, b, w)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the `out=` form writes the channels into a wider zero buffer
    buf = torch.zeros(2, h // 2, h // 2, c // 2 + 32)
    tdn.transition_fused(*[torch.from_numpy(v) for v in (x, a, b, w)], out=buf)
    np.testing.assert_allclose(buf[..., :c // 2].numpy(), want, rtol=1e-4,
                               atol=1e-5)
    assert not buf[..., c // 2:].any()


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(3)
    s, b, m = (rng.randn(8).astype(np.float32) for _ in range(3))
    v = rng.rand(8).astype(np.float32) + 0.1
    want = jpd.fold_bn(*map(jnp.asarray, (s, b, m, v)))
    got = tdn.fold_bn(*map(torch.from_numpy, (s, b, m, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.fixture(scope="module")
def kimia_vars():
    """Jittered flax variables, the 32x32 input, and the JAX outputs of
    KimiaNet.apply and kimianet_fused_apply(interpret=True)."""
    x = jnp.asarray(np.random.RandomState(1).rand(1, 32, 32, 3)
                    .astype(np.float32))
    variables = jax.jit(jdn.KimiaNet().init)(jax.random.PRNGKey(0), x)
    # jitter the running stats so the BN folding is non-trivial
    variables = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a,
                             variables)
    want = jax.jit(lambda v, x: jdn.KimiaNet().apply(v, x, train=False))(
        variables, x)
    fpj = jdn.fuse_kimianet(variables, dtype=jnp.float32)
    want += jdn.kimianet_fused_apply(fpj, x, interpret=True)
    return (np.array(x), jax.tree.map(np.asarray, variables),
            [np.asarray(w) for w in want])


@pytest.mark.parametrize("path", ["unfused", "fused"])
def test_kimianet_matches_flax(kimia_vars, path):
    """Port KimiaNet, unfused and fused (plain kernels), vs flax
    KimiaNet.apply and kimianet_fused_apply(interpret=True) on 32x32."""
    x, variables, (o1_ref, o3_ref, o1_fj, o3_fj) = kimia_vars
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if path == "unfused":
            model = convert.load_flax_variables(tfd.KimiaNet(), variables).eval()
            o1, o3 = model(xt)
        else:
            o1, o3 = tfd.kimianet_fused_apply(
                tfd.fuse_kimianet(variables, dtype=torch.float32), xt)
    for got, want in ((o1, o1_ref), (o3, o3_ref), (o1, o1_fj), (o3, o3_fj)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_weight_bridge_round_trip(kimia_vars):
    _, variables, _ = kimia_vars
    model = convert.load_flax_variables(tfd.KimiaNet(), variables)
    back = convert.to_flax_variables(model)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
    with pytest.raises(KeyError):
        convert.load_flax_variables(tfd.KimiaNet(),
                                    {"params": {}, "batch_stats": {}})


def test_seeded_init_follows_flax_distributions():
    """lecun-normal kernels (variance 1/fan_in, flax's fan-in rule), BN
    1/0/0/1, zero biases; the same seed gives the same weights."""
    model = convert.init_flax_like_(tfd.KimiaNet(), seed=0)
    w = model.backbone.denseblock3_layer5.conv1.weight  # fan-in 384
    assert abs(w.std().item() * np.sqrt(384) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.8796 / np.sqrt(384) + 1e-6
    bn = model.backbone.norm5
    assert (bn.weight == 1).all() and (bn.running_var == 1).all()
    assert not bn.bias.any() and not bn.running_mean.any()
    assert not model.fc_4.bias.any()
    again = convert.init_flax_like_(tfd.KimiaNet(), seed=0)
    assert torch.equal(again.backbone.conv0.weight, model.backbone.conv0.weight)
