"""Port parity of the MIL bag baselines (wsi_hgnn_tpu_torch/models/mil,
wsi_hgnn_tpu_torch/train_mil.py) against the JAX package and the root
train_mil.py on the CPU: the same numpy bags, the same weights carried
across by `convert`.

ABMIL, DSMIL and GTN forwards to 1e-5 and gradients to 1e-4 relative;
dense_mincut_pool; k-means from the same initial centres, reduce_bag and
mix_aug equal; 5-step lockstep trajectories of each model against JAX's
optimizer chain (float64 on both sides, 1e-7). The k-fold script is held
against JAX's in tests/test_torch_train_mil.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import train_mil as jtrain
from wsi_hgnn_tpu.models import mil as jmil
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch import train_mil as ttrain
from wsi_hgnn_tpu_torch.models import mil as tmil
import port_threads  # noqa: F401  (torch threads per test worker)

D, C, CAP = 16, 2, 48


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def bag(n=30, seed=0):
    rng = np.random.RandomState(seed)
    return tmil.pad_bag(rng.randn(n, D).astype(np.float32), capacity=CAP)


def gtn_inputs(n=40, seed=0, cap=64):
    rng = np.random.RandomState(seed)
    f, m = tmil.pad_bag(rng.randn(n, D).astype(np.float32) + 0.2,
                        capacity=cap)
    src, dst = tmil.spatial_adjacency(
        [tuple(c) for c in ttrain.grid_coords(n)])
    adj = np.zeros((cap, cap), np.float32)
    adj[src, dst] = 1.0
    return f[None], adj[None], m[None]


def pair(kind, seed=1):
    """(jax model, port model, flax variables of the port's seeded init)."""
    if kind == "abmil":
        jm, tm = jmil.ABMIL(num_classes=C), tmil.ABMIL(C, D)
    elif kind == "dsmil":
        jm, tm = jmil.DSMIL(num_classes=C), tmil.DSMIL(C, D)
    elif kind == "gated":
        jm, tm = jmil.GatedABMIL(hidden_dim=8), tmil.GatedABMIL(D, 8)
    else:
        jm = jmil.GraphTransformer(n_class=C, in_dim=D, embed_dim=16,
                                   node_cluster_num=8, depth=2)
        tm = tmil.GraphTransformer(C, D, 16, 8, depth=2)
    variables = convert.to_flax_variables(convert.init_flax_like_(tm, seed))
    return jm, tm, jax.tree.map(jnp.asarray, variables)


@pytest.mark.parametrize("kind", ["abmil", "dsmil", "gated", "gtn"])
def test_port_tree_equals_jax_init_tree(kind):
    """Same leaves, same shapes as flax's init (so checkpoints and fold
    pickles cross), and init_flax_like_ draws DSMIL's fcc_kernel."""
    jm, _, variables = pair(kind)
    if kind == "gtn":
        want = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                *map(jnp.asarray, gtn_inputs()))
    else:
        f, m = bag()
        want = jm.init(jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(m))
    got, want = flat(variables), flat(want)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    if kind == "dsmil":
        w = got["params/b_classifier/fcc_kernel"]
        assert 0.5 < w.std() * np.sqrt(C * D) / 0.88 < 2.0


def _grads_close(got, want, rtol=1e-4):
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * np.abs(want[k]).max()
                                   + 1e-6 * top, err_msg=k)


def _port_grads(tm):
    return flat(convert.params_to_flax(tm, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in tm.named_parameters()}))


@pytest.mark.parametrize("kind", ["abmil", "dsmil", "gated"])
def test_bag_model_forward_and_gradients_match_jax(kind):
    jm, tm, variables = pair(kind)
    f, m = bag()
    coef = np.linspace(-1, 1, C).astype(np.float32)

    def out(v):
        o = jm.apply(v, jnp.asarray(f), jnp.asarray(m))
        return o[1] if kind == "dsmil" else o[0] if kind == "gated" else o

    want = np.asarray(out(variables))
    want_g = flat(jax.grad(lambda p: (out({"params": p})
                                      * coef[:out(variables).shape[-1]]).sum())(
        variables["params"]))
    o = tm(torch.from_numpy(f), torch.from_numpy(m))
    o = o[1] if kind == "dsmil" else o[0] if kind == "gated" else o
    np.testing.assert_allclose(o.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (o * torch.from_numpy(coef[:o.shape[-1]])).sum().backward()
    _grads_close(_port_grads(tm), want_g)


def test_gtn_forward_gradients_and_batch_stats_match_jax():
    """Training mode (masked batch statistics, updated running ones), the
    logits, the mincut + orthogonality loss and every gradient."""
    jm, tm, variables = pair("gtn")
    inputs = gtn_inputs()
    j_in = [jnp.asarray(a) for a in inputs]

    def loss(p):
        (logits, aux), upd = jm.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, *j_in,
            train=True, mutable=["batch_stats"])
        return (logits[0, 0] - 2 * logits[0, 1] + aux), (logits, aux, upd)

    want_g, (logits, aux, upd) = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])
    tm.train()
    t_logits, t_aux = tm(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(t_logits.detach().numpy(), logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(t_aux.detach()), float(aux), rtol=1e-5)
    (t_logits[0, 0] - 2 * t_logits[0, 1] + t_aux).backward()
    _grads_close(_port_grads(tm), flat(want_g))
    got_bs = flat(convert.to_flax_variables(tm)["batch_stats"])
    for k, v in flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(got_bs[k], v, rtol=1e-5, atol=1e-6)
    tm.eval()
    with torch.no_grad():
        ev = tm(*map(torch.from_numpy, inputs))[0].numpy()
    want_ev = jm.apply({"params": variables["params"],
                        "batch_stats": upd["batch_stats"]}, *j_in)[0]
    np.testing.assert_allclose(ev, want_ev, rtol=1e-5, atol=1e-5)


def test_dense_mincut_pool_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 6).astype(np.float32)
    adj = (rng.rand(2, 12, 12) < 0.3).astype(np.float32)
    s = rng.randn(2, 12, 4).astype(np.float32)
    mask = np.arange(12)[None, :] < np.array([[12], [9]])
    want = jmil.dense_mincut_pool(*(jnp.asarray(a) for a in (x, adj, s)),
                                  jnp.asarray(mask, jnp.float32))
    got = tmil.dense_mincut_pool(*(torch.from_numpy(a) for a in (x, adj, s)),
                                 torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# ReMix
# ---------------------------------------------------------------------------
def jax_kmeans_pp(feats, k, seed):
    """The initial centres the JAX package's kmeans draws (its k-means++
    loop, step for step)."""
    feats = jnp.asarray(feats)
    n = feats.shape[0]
    key = jax.random.PRNGKey(seed)
    cents = [feats[jax.random.randint(key, (), 0, n)]]
    d2min = jnp.sum((feats - cents[0]) ** 2, axis=1)
    for _ in range(1, k):
        key, sub = jax.random.split(key)
        probs = d2min / jnp.maximum(d2min.sum(), 1e-12)
        c = feats[jax.random.choice(sub, n, p=probs)]
        cents.append(c)
        d2min = jnp.minimum(d2min, jnp.sum((feats - c) ** 2, axis=1))
    return np.asarray(jnp.stack(cents))


def blobs(seed=0, n=90):
    rng = np.random.RandomState(seed)
    centres = rng.randn(4, D) * 4
    return (centres[rng.randint(0, 4, n)] + rng.randn(n, D)).astype(np.float32)


def test_kmeans_from_the_same_centres_matches_jax():
    feats = blobs()
    init = jax_kmeans_pp(feats, 5, 66)
    want_c, want_a = jmil.kmeans(jnp.asarray(feats), 5, seed=66)
    got_c, got_a = tmil.kmeans(torch.from_numpy(feats), 5,
                               init_centroids=torch.from_numpy(init.copy()))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    # its own seeded draw: deterministic, a valid clustering
    c1, a1 = tmil.kmeans(torch.from_numpy(feats), 5, seed=3)
    c2, a2 = tmil.kmeans(torch.from_numpy(feats), 5, seed=3)
    assert torch.equal(a1, a2) and torch.equal(c1, c2)
    d2 = ((torch.from_numpy(feats)[:, None] - c1[None]) ** 2).sum(-1)
    assert torch.equal(d2.argmin(1), a1)


def test_reduce_bag_and_mix_aug_match_jax():
    feats = blobs(1)
    init = jax_kmeans_pp(feats, 4, 66)
    want_p, want_s = jmil.reduce_bag(feats, 4, num_shift_vectors=20)
    got_p, got_s = tmil.reduce_bag(feats, 4, num_shift_vectors=20,
                                   init_centroids=init)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)
    tgt = want_p + 0.5          # a reduced target bag: shifts per row
    for mode in ("replace", "append", "interpolate", "cov", "joint"):
        got = tmil.mix_aug(feats[:20], tgt, mode=mode, rate=0.5, strength=0.3,
                           shift=want_s, rng=np.random.RandomState(4))
        want = jmil.mix_aug(feats[:20], tgt, mode=mode, rate=0.5,
                            strength=0.3, shift=want_s,
                            rng=np.random.RandomState(4))
        np.testing.assert_array_equal(got, want, err_msg=mode)
    labels = np.array([0, 1, 0, 1])
    bags = [want_p + s for s in range(4)]      # prototype bags, as reduced
    shifts = [want_s] * 4
    for mode in ("append", "cov"):
        got = tmil.mix_the_bag_aug(bags[0], 0, bags, labels, mode, 0.4,
                                   shifts, np.random.RandomState(8))
        want = jmil.mix_the_bag_aug(bags[0], 0, bags, labels, mode, 0.4,
                                    shifts, np.random.RandomState(8))
        np.testing.assert_array_equal(got, want, err_msg=mode)


# ---------------------------------------------------------------------------
# training: lockstep steps, the k-fold main
# ---------------------------------------------------------------------------
def jax_bag_chain(lr, wd, epochs, steps_per_epoch):
    lr_of = jtrain.cosine_epoch_schedule(lr, epochs, steps_per_epoch)
    return optax.chain(optax.add_decayed_weights(wd),
                       optax.scale_by_adam(b1=0.5, b2=0.9),
                       optax.scale_by_schedule(lambda c: -lr_of(c)))


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


# ABMIL's attention bias sits under the instance softmax: its loss gradient
# is exactly 0, so its steps are coupled L2 through Adam seeded by rounding
# noise, which Adam's normalisation amplifies step after step in either
# package. The loss does not depend on it; the trained logits are compared.
INVARIANT = ("params/attention_1/bias",)


def assert_trajectories_match(tm, want, losses_got, losses_want):
    """Lockstep in float64 on both sides (so the rounding noise of the
    exactly-zero gradients of shift-invariant directions, an attention
    unit active on every instance, stays far below Adam's eps): every
    step's loss, and every parameter after the last step to 1e-7
    relative of its leaf's scale but INVARIANT."""
    np.testing.assert_allclose(losses_got, losses_want, rtol=1e-9)
    got = flat(convert.to_flax_variables(tm))
    want = flat(want)
    assert sorted(got) == sorted(want)
    for k in sorted(set(want) - set(INVARIANT)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7,
                                   atol=1e-7 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["abmil", "dsmil"])
def test_bag_model_lockstep_trajectory_matches_jax(kind):
    """5 steps over 3 bags, 2 steps an epoch (so the cosine LR moves),
    from one init: the port's bag_train_step and Adam(betas 0.5, 0.9,
    coupled L2) against JAX's optax chain and loss."""
    jm, tm, variables = pair(kind)
    lr, wd, epochs, spe = 1e-2, 5e-3, 3, 2
    tm.double()

    def loss(p, f, m, y):
        onehot = jax.nn.one_hot(y, C)[None]
        if kind == "abmil":
            b = jm.apply(p, f, m)
            mx = b
        else:
            cls, b, _, _ = jm.apply(p, f, m, train=False)
            mx = jnp.where(m[:, None], cls, -1e30).max(0, keepdims=True)
        return jtrain.mil_reference_loss(kind, b, mx, onehot)

    opt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.5, 0.9),
                           weight_decay=wd)
    lr_of = ttrain.cosine_epoch_schedule(lr, epochs)
    bags = [bag(20 + 5 * i, seed=i) for i in range(3)]
    l_got, l_want = [], []
    with jax.enable_x64(True):
        tx = jax_bag_chain(lr, wd, epochs, spe)
        params = f64(variables)
        state = tx.init(params)
        vg = jax.jit(jax.value_and_grad(loss), static_argnums=3)
        for step in range(5):
            f, m = bags[step % 3]
            f = f.astype(np.float64)
            y = step % 2
            lv, g = vg(params, jnp.asarray(f), jnp.asarray(m), y)
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
            l_want.append(float(lv))
            ttrain._set_lr(opt, lr_of(step // spe))
            l_got.append(float(ttrain.bag_train_step(
                tm, opt, kind, C, torch.from_numpy(f), torch.from_numpy(m),
                y)))
        logits_want = [np.asarray(_jax_bag(jm, kind, params, f.astype(
            np.float64), m)) for f, m in bags]
        params = jax.tree.map(np.asarray, params)
    assert_trajectories_match(tm, params, l_got, l_want)
    with torch.no_grad():
        for (f, m), want in zip(bags, logits_want):
            got = ttrain.bag_logits(tm, kind, torch.from_numpy(
                f.astype(np.float64)), torch.from_numpy(m))[0].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def _jax_bag(jm, kind, params, f, m):
    out = jm.apply(params, jnp.asarray(f), jnp.asarray(m))
    return out if kind == "abmil" else out[1]


def test_gtn_lockstep_trajectory_matches_jax():
    """5 GTN steps (training-mode BatchNorm, running statistics carried)
    against JAX's Adam(wd 5e-4) chain with the cosine epoch LR."""
    jm, tm, variables = pair("gtn")
    lr, epochs, spe = 1e-3, 3, 2
    tm.double()
    opt = torch.optim.Adam(tm.parameters(), lr=lr, weight_decay=5e-4)
    t_lr = ttrain.cosine_epoch_schedule(lr, epochs)
    inputs = [tuple(a.astype(np.float64) if a.dtype == np.float32 else a
                    for a in gtn_inputs(30 + 6 * i, seed=i, cap=48))
              for i in range(3)]
    l_got, l_want = [], []
    with jax.enable_x64(True):
        lr_of = jtrain.cosine_epoch_schedule(lr, epochs, spe)
        tx = optax.chain(optax.add_decayed_weights(5e-4),
                         optax.scale_by_adam(),
                         optax.scale_by_schedule(lambda c: -lr_of(c)))
        v64 = f64(variables)
        params, bstats = v64["params"], v64["batch_stats"]
        state = tx.init(params)

        def loss_fn(p, bstats, f, a, m, y):
            (logits, aux), upd = jm.apply(
                {"params": p, "batch_stats": bstats}, f, a, m, train=True,
                mutable=["batch_stats"])
            return -jax.nn.log_softmax(logits)[0, y] + aux, upd["batch_stats"]

        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                     static_argnums=5)
        for k in range(5):
            f, a, m = inputs[k % 3]
            y = k % 2
            (lv, bstats), g = vg(params, bstats, *map(jnp.asarray, (f, a, m)),
                                 y)
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
            l_want.append(float(lv))
            ttrain._set_lr(opt, t_lr(k // spe))
            l_got.append(float(ttrain.gtn_train_step(
                tm, opt, *map(torch.from_numpy, (f, a, m)), y)))
        want = jax.tree.map(np.asarray, {"params": params,
                                         "batch_stats": bstats})
    assert_trajectories_match(tm, want, l_got, l_want)
