"""Port parity: the host-callable HoVer-Net typing stage
(models/featurizers/__init__.py::make_hover_typing) against the JAX
package's on the same weights, at 256x256 on the CPU."""
import numpy as np
import pytest
import torch

import jax

from wsi_hgnn_tpu.models.featurizers import make_hover_typing as jax_typing
from wsi_hgnn_tpu_torch.models.featurizers import make_hover_typing
import port_threads  # noqa: F401  (torch threads per test worker)


def test_make_hover_typing_matches_jax(monkeypatch):
    """numpy f32 patches in, numpy int32 types out, equal to JAX's on the
    same weights (seeded flax-layout ones, running statistics jittered so
    every BatchNorm acts); uint8 patches are scaled to [0, 1] on the
    device and type the same."""
    import jax.numpy as jnp

    from wsi_hgnn_tpu.models import featurizers as jfeat
    from wsi_hgnn_tpu_torch import convert as bridge
    from wsi_hgnn_tpu_torch.models.featurizers import HoVerNet

    variables = bridge.to_flax_variables(bridge.init_flax_like_(
        HoVerNet.typing(6, "fast"), 51))
    variables = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a,
                             variables)

    def load(hovernet_config, nr_types, with_fc1=True):
        # the JAX package's loader, handed these weights instead of its
        # op-by-op init (no weight file is named)
        assert not with_fc1 and nr_types == 6
        return (jfeat.HoVerNet(nr_types=6, mode="fast", with_fc1=False),
                jax.tree.map(jnp.asarray, variables), jnp.float32)

    monkeypatch.setattr(jfeat, "_load_hover_variables", load)
    cfg = {"mode": "fast"}
    px = np.random.RandomState(50).randint(0, 256, (2, 256, 256, 3)
                                            ).astype(np.uint8)
    f32 = px.astype(np.float32) / 255.0
    want = jax_typing(cfg, 6)(f32)

    typing = make_hover_typing(cfg, 6, device="cpu", variables=variables)
    got = typing(f32)
    assert got.dtype == np.int32 and got.shape == (2,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(typing(px), got)


def test_make_hover_typing_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hover_typing({"mode": "fast"}, 6)
