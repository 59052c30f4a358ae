"""Port parity of GraphCAM (wsi_hgnn_tpu_torch/models/mil/relprop.py and
graph_transformer.graphcam) against the JAX package on the CPU, the
GraphTransformer weights carried across by `convert`.

`safe_divide` turns differences of 1e-7 in a denominator near 0 into
large relevance differences, so the relprop is held against JAX in
float64 on both sides (JAX under jax.enable_x64): the rule functions,
`vit_forward`, each `vit_relprop` method and `graphcam` within 1e-10
relative (of the result's largest magnitude). In f32 `vit_relprop` and
`graphcam` are held to JAX's f32 rounding: the port's f32 result lies
within 3 times JAX's f32 distance from the float64 result plus 1e-4
(relative L2; JAX's own f32 result is up to 2e-3 away on these inputs)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.models.mil import graph_transformer as jgt
from wsi_hgnn_tpu.models.mil import relprop as jrp
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch import train_mil as ttrain
from wsi_hgnn_tpu_torch.models import mil as tmil
from wsi_hgnn_tpu_torch.models.mil import relprop as trp
import port_threads  # noqa: F401  (torch threads per test worker)

D, C, EMBED, CLUSTERS, DEPTH = 16, 3, 32, 8, 2
METHODS = ("transformer_attribution", "grad", "rollout", "last_layer_attn")


def close64(got, want, rtol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / np.linalg.norm(np.asarray(want)))


def f32_close(got32, want32, want64):
    """The port's f32 result near the float64 one: 3x JAX's f32 distance
    plus 1e-4, relative L2."""
    err, ref = rel_l2(got32, want64), rel_l2(want32, want64)
    assert err <= 3.0 * ref + 1e-4, (err, ref)


def model_pair(seed=3):
    """A trained-looking GTN: seeded weights, a nonzero cls token and
    running statistics, as (port module, flax variables)."""
    tm = tmil.GraphTransformer(C, D, EMBED, CLUSTERS, depth=DEPTH)
    convert.init_flax_like_(tm, seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        tm.cls_token.copy_(torch.from_numpy(
            rng.randn(1, 1, EMBED).astype(np.float32) * 0.5))
        tm.conv1.bn.mean.copy_(torch.from_numpy(
            rng.randn(EMBED).astype(np.float32) * 0.05))
        tm.conv1.bn.var.copy_(torch.from_numpy(
            rng.rand(EMBED).astype(np.float32) * 0.02 + 0.01))
    return tm.eval(), convert.to_flax_variables(tm)


def gtn_inputs(n=45, cap=64, seed=0):
    rng = np.random.RandomState(seed)
    f, m = tmil.pad_bag(rng.randn(n, D).astype(np.float32) + 0.3,
                        capacity=cap)
    src, dst = tmil.spatial_adjacency(
        [tuple(c) for c in ttrain.grid_coords(n)])
    adj = np.zeros((cap, cap), np.float32)
    adj[src, dst] = 1.0
    return f[None], adj[None], m[None]


def tokens(seed=1, n=CLUSTERS + 1):
    return np.random.RandomState(seed).randn(1, n, EMBED) * 0.7


def test_rule_functions_match_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(5, 7)
    b = rng.randn(5, 7) * 1e-8
    b[0, :3] = 0.0
    b[1, :3] = (-1e-9, 1e-9, 2e-9)
    w = rng.randn(7, 4)
    x = rng.randn(3, 7)
    R = rng.randn(3, 4)
    q, k = rng.randn(1, 2, 5, 3), rng.randn(1, 2, 6, 3)
    Rqk = rng.randn(1, 2, 5, 6)
    x0, x1 = rng.randn(4, 6), rng.randn(4, 6)
    R01 = rng.randn(4, 6)
    t = torch.from_numpy
    with jax.enable_x64(True):
        j = jnp.asarray
        close64(trp.safe_divide(t(a), t(b)), jrp.safe_divide(j(a), j(b)))
        close64(trp.linear_relprop(t(R), t(x), t(w)),
                jrp.linear_relprop(j(R), j(x), j(w)))
        got = trp.simple_relprop(
            lambda u, v: torch.einsum("bhid,bhjd->bhij", u, v),
            t(Rqk), t(q), t(k))
        want = jrp.simple_relprop(
            lambda u, v: jnp.einsum("bhid,bhjd->bhij", u, v),
            j(Rqk), j(q), j(k))
        for g, w_ in zip(got, want):
            close64(g, w_)
        for g, w_ in zip(trp.add_relprop(t(R01), t(x0), t(x1)),
                         jrp.add_relprop(j(R01), j(x0), j(x1))):
            close64(g, w_)
        close64(trp.clone_relprop([t(R01), t(x1)], t(x0)),
                jrp.clone_relprop([j(R01), j(x1)], j(x0)))
        mats = [rng.rand(1, 5, 5) for _ in range(3)]
        for start in (0, 1):
            close64(trp.compute_rollout_attention([t(m) for m in mats], start),
                    jrp.compute_rollout_attention([j(m) for m in mats], start))


def test_vit_forward_and_attention_gradients_match_jax():
    tm, variables = model_pair()
    x = tokens()
    taps = [np.random.RandomState(i).randn(1, 8, x.shape[1], x.shape[1])
            * 1e-3 for i in range(DEPTH)]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           variables["params"])
        want = jrp.vit_forward(p64, jnp.asarray(x),
                               attn_taps=[jnp.asarray(a) for a in taps])
        want_g = jax.grad(lambda tp: jrp.vit_forward(
            p64, jnp.asarray(x), attn_taps=tp)[0, 1])(
            [jnp.asarray(a) for a in taps])
    tm.double()
    tt = [torch.from_numpy(a).requires_grad_() for a in taps]
    got = trp.vit_forward(tm, torch.from_numpy(x), attn_taps=tt)
    close64(got.detach(), want)
    got[0, 1].backward()
    for g, w in zip(tt, want_g):
        close64(g.grad, w)


@pytest.mark.parametrize("method", METHODS)
def test_vit_relprop_matches_jax(method):
    """float64 on both sides within 1e-10; f32 to JAX's f32 rounding."""
    tm, variables = model_pair()
    x = tokens()
    for cls in range(C):
        want32 = np.asarray(jrp.vit_relprop(
            variables["params"], jnp.asarray(x, jnp.float32), cls,
            method=method))
        got32 = trp.vit_relprop(tm, torch.from_numpy(x).float(), cls,
                                method=method).numpy()
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               variables["params"])
            want = jrp.vit_relprop(p64, jnp.asarray(x), cls, method=method)
        f32_close(got32, want32, want)
        got = trp.vit_relprop(tm.double(), torch.from_numpy(x), cls,
                              method=method)
        tm.float()
        assert got.shape == (CLUSTERS,)
        close64(got, want)
    with pytest.raises(NotImplementedError):
        trp.vit_relprop(tm, torch.from_numpy(x).float(), 0, method="nope")


@pytest.mark.parametrize("n", [45, 64])
def test_graphcam_matches_jax(n):
    """GraphCAM per node for every class, a ragged bag and a full one;
    the module's training mode is restored."""
    tm, variables = model_pair(seed=5)
    f, a, m = gtn_inputs(n=n)
    jm = jgt.GraphTransformer(n_class=C, in_dim=D, embed_dim=EMBED,
                              node_cluster_num=CLUSTERS, depth=DEPTH)
    tm.train()
    for cls in range(C):
        want32 = np.asarray(jgt.graphcam(jm, variables, *map(jnp.asarray,
                                                             (f, a, m)), cls))
        got32 = tmil.graphcam(tm, *map(torch.from_numpy, (f, a, m)),
                              cls).numpy()
        assert tm.training
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                               variables)
            want = jgt.graphcam(jm, v64, *(jnp.asarray(x, jnp.float64)
                                           for x in (f, a)),
                                jnp.asarray(m), cls)
        f32_close(got32, want32, want)
        tm.double()
        got = tmil.graphcam(tm, *(torch.from_numpy(x).double()
                                  for x in (f, a)), torch.from_numpy(m), cls)
        tm.float()
        assert got.shape == (f.shape[1],)
        assert not got[n:].any()
        close64(got, want)
