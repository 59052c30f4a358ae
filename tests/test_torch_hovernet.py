"""Port parity: HoVer-Net typing (wsi_hgnn_tpu_torch/models/featurizers/
hovernet.py) against the flax HoVer-Net on JAX-initialised weights at
256x256, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.models.featurizers import hovernet as jhv
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.models.featurizers import hovernet as thv
import port_threads  # noqa: F401  (torch threads per test worker)


@pytest.fixture(scope="module")
def hover():
    """flax variables (typing-only net), two asymmetric 256x256 patches,
    and the flax tp logits / node types on the constructor orientation."""
    model = jhv.HoVerNet(nr_types=6, mode="fast", with_fc1=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 256, 256, 3)))
    # jitter the running stats so every BatchNorm is non-trivial
    variables = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a,
                             variables)
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 256, 256, 3))

    @jax.jit
    def tp_of(v, imgs):
        d = model.apply(v, jhv._constructor_orientation(imgs), method="encode")
        return model.apply(v, "tp", d, method="decode_branch")

    tp = tp_of(variables, x)
    types = jhv.hovernet_typing_apply(model, variables, x)
    return (jax.tree.map(np.asarray, variables), np.array(x), np.asarray(tp),
            np.asarray(types))


def test_hovernet_typing_matches_flax(hover):
    """tp logits to rtol 1e-3 / atol 1e-4 (f32 through ~100 convolutions
    summed in another order), node types exactly equal, and the H/W
    transpose is load-bearing."""
    variables, x, tp_ref, types_ref = hover
    model = convert.load_flax_variables(thv.HoVerNet.typing(6, "fast"),
                                        variables)
    model.eval()
    xt = torch.from_numpy(x)

    def tp_of(imgs):
        return model.decode_branch("tp", model.encode(imgs))

    with torch.no_grad():
        tp = tp_of(thv._constructor_orientation(xt).permute(0, 3, 1, 2))
        types = thv.hovernet_typing_apply(model, xt)
        tp_plain = tp_of(xt.permute(0, 3, 1, 2))
    assert not torch.allclose(tp_plain, tp, atol=1e-3)
    tp = tp.permute(0, 2, 3, 1).numpy()
    assert tp.shape == (2, 164, 164, 6)
    np.testing.assert_allclose(tp, tp_ref, rtol=1e-3, atol=1e-4)
    assert types.dtype == torch.int32
    np.testing.assert_array_equal(types.numpy(), types_ref)


def test_tf_same_pad_and_crop_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 9, 9, 2).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for k, s in ((3, 2), (7, 1), (3, 1), (5, 2)):
        want = np.asarray(jhv.tf_same_pad(jnp.asarray(x), k, s))
        got = thv.tf_same_pad(xt, k, s).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jhv.crop_op(jnp.asarray(x), (3, 4)))
    got = thv.crop_op(xt, (3, 4)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_node_types_on_device_ties_and_no_nucleus():
    """Equal class counts go to the lowest class, class 0 never wins, a
    patch with no nucleus pixel gets 0; matches both JAX typing paths."""
    rng = np.random.RandomState(0)
    tp = rng.randn(16, 12, 12, 6).astype(np.float32)
    tp[:4, :, :, 1:] -= 100.0           # all background
    tp[4] = -10.0                       # exact tie: classes 2 and 5, 72 px each
    tp[4, :6, :, 2] = 5.0
    tp[4, 6:, :, 5] = 5.0
    tp[5] = -10.0                       # tie between 3 and background
    tp[5, :6, :, 3] = 5.0
    tp[5, 6:, :, 0] = 5.0
    got = thv.node_types_on_device(torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jhv.node_types_on_device(jnp.asarray(tp))))
    np.testing.assert_array_equal(got, jhv.node_types_from_tp(tp))
    assert (got[:4] == 0).all() and got[4] == 2 and got[5] == 3
