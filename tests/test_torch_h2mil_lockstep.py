"""A 5-step H2MIL training lockstep of the port against the JAX package on
the CPU: the reference loss (CE of the softmax), dropout off, Adam with
coupled L2 5e-4 (JAX: add_decayed_weights then scale_by_adam), float64 on
both sides; every loss within 1e-9 and every leaf after the last step
within 1e-7 of its scale, IHPool's gradient-free weights (which only the
decay moves) included. JAX runs eagerly (see the step loop)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_h2mil import C, D, flat, single_level, to_port
from wsi_hgnn_tpu.models.mil import h2mil as jh2
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.models.mil import h2mil as th2
import port_threads  # noqa: F401  (torch threads per test worker)


def test_h2mil_lockstep_trajectory_matches_jax():
    """5 steps over 3 trees of the reference loss (CE of the softmax),
    dropout off, Adam with coupled L2 5e-4, float64 on both sides: every
    loss and every leaf after the last step, the pool weights (which only
    the decay moves) included."""
    from wsi_hgnn_tpu_torch import train_mil as ttrain

    lr = 3e-3
    trees = [single_level(n=40 + 10 * i, seed=i, cap_n=128, cap_e=768)
             for i in range(3)]
    tm = convert.init_flax_like_(th2.H2MIL(D, 16, C, k1=4, k2=8,
                                           dropout=0.0), 6)
    variables = convert.to_flax_variables(tm)
    tm.double()
    opt = torch.optim.Adam(tm.parameters(), lr=lr, weight_decay=5e-4)
    jm = jh2.H2MIL(hidden_dim=16, n_classes=C, k1=4, k2=8, dropout=0.0)
    l_got, l_want = [], []
    with jax.enable_x64(True):
        tx = optax.chain(optax.add_decayed_weights(5e-4),
                         optax.scale_by_adam(), optax.scale(-lr))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables)
        state = tx.init(params)

        def loss_fn(p, tree, y):
            probs = jax.nn.softmax(jm.apply(p, tree, train=True))
            return -jax.nn.log_softmax(probs)[0, y]

        # eager, not jitted: on the first tree XLA's fused float64 forward
        # rounds differently from the unfused one, enough to move an
        # IHPool assignment (the eager JAX forward equals the port's)
        vg = jax.value_and_grad(loss_fn)
        for k in range(5):
            t = trees[k % 3]
            y = k % 2
            jt = jh2.TreeGraph(*(jnp.asarray(a, jnp.float64)
                                 if a.dtype == np.float32 else jnp.asarray(a)
                                 for a in t))
            lv, g = vg(params, jt, y)
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
            l_want.append(float(lv))
            l_got.append(float(ttrain.h2mil_train_step(
                tm, opt, to_port(t, torch.float64), y)))
        want = flat(jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(l_got, l_want, rtol=1e-9)
    got = flat(convert.to_flax_variables(tm))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7,
                                   atol=1e-7 * np.abs(want[k]).max(),
                                   err_msg=k)
    w0 = flat(variables)["params/pool_1/weight_1"]
    assert not np.array_equal(got["params/pool_1/weight_1"], w0)
