"""Port parity of lattice training (wsi_hgnn_tpu_torch/models/lattice.py
training mode, graph/ops.py backward, config.py optimizers and losses,
train/trainer.py::lattice_train_step) against the JAX package, on the
CPU: the augmentation fed JAX's masks, gradients in the shifted-softmax
branch, and lockstep training trajectories for every optimizer branch and
both losses."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.config import parse_loss as jax_parse_loss
from wsi_hgnn_tpu.config import parse_optimizer as jax_parse_optimizer
from wsi_hgnn_tpu.models import lattice as jlat
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import parse_loss, parse_optimizer
from wsi_hgnn_tpu_torch.graph import ops as tops
from wsi_hgnn_tpu_torch.models import lattice as tlat
from wsi_hgnn_tpu_torch.train.trainer import lattice_train_step
import port_threads  # noqa: F401  (torch threads per test worker)

B, N, D, T, R = 2, 48, 16, 6, 4
CLASSES = {"heat2": (jlat.HEATNet2Lattice, tlat.HEATNet2Lattice),
           "heat4": (jlat.HEATNet4Lattice, tlat.HEATNet4Lattice)}


def _graphs(seed):
    """One [2, 48, 3] lattice batch in both packages; slide 0 misses node
    types 2..5, slide 1 has 10 padding rows."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, D).astype(np.float32)
    ntypes = rng.randint(0, T, (B, N)).astype(np.int32)
    ntypes[0] %= 2
    mask = np.arange(N)[None, :] < np.array([N, N - 10])[:, None]
    g_j = jlat.build_lattice_device(jnp.asarray(feats), jnp.asarray(ntypes),
                                    jnp.asarray(mask), R, T)
    g_t = tlat.LatticeGraph(*(
        torch.from_numpy(np.asarray(a)).to(
            torch.int64 if np.issubdtype(np.asarray(a).dtype, np.integer)
            else None) for a in g_j))
    return g_j, g_t


@functools.lru_cache(maxsize=None)
def _jax_init(which, seed, n_layers, presence):
    """The flax model and its initial params, made once per model: each
    lockstep case trains its own torch copy of them."""
    g_j, _ = _graphs(seed)
    jm = CLASSES[which][0](**_widths(n_layers, presence))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(seed), g_j)["params"]


def _widths(n_layers, presence):
    return dict(in_dim=D, hidden_dim=16, out_dim=2, n_layers=n_layers,
                n_heads=2, n_node_types=T, dropout=0.0, presence=presence)


def _pair(which, seed=0, n_layers=2, presence="batch"):
    g_j, g_t = _graphs(seed)
    jm, params = _jax_init(which, seed, n_layers, presence)
    tm = convert.load_flax_variables(
        CLASSES[which][1](**_widths(n_layers, presence)),
        {"params": jax.tree.map(np.asarray, params)})
    return jm, tm, params, g_j, g_t


@jax.jit
def _jax_masks(key, g):
    """The masks jax lattice_train_transform draws from `key` (p = 0.5)."""
    k1, k2, k3 = jax.random.split(key, 3)
    b, n, k = g.idx.shape
    return (jax.random.bernoulli(k1, 0.5, (b, n)),
            jax.random.bernoulli(k2, 0.5, (b, n, k)),
            jax.random.bernoulli(k3, 0.5, (g.feats.shape[-1],)))


def _torch_masks(masks):
    return tlat.TrainMasks(*(torch.from_numpy(np.asarray(m)) for m in masks))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_params_close(jax_params, model, atol):
    want = _flat(jax.tree.map(np.asarray, dict(jax_params)))
    got = _flat(convert.params_to_flax(model, dict(model.named_parameters())))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)


def test_typed_linear_ragged_backward_matches_onehot():
    """The grouped per-type product differentiates (it wrote through
    `out=` before, which autograd rejects) and gives typed_linear's
    gradients; type 5 has no rows."""
    rng = np.random.RandomState(7)
    arrays = (rng.randn(40, 8), rng.randint(0, 5, 40), rng.randn(6, 8, 4),
              rng.randn(6, 4))
    grads = []
    for fn in (tops.typed_linear, tops.typed_linear_ragged):
        feat, w, b = (torch.tensor(a, dtype=torch.float32, requires_grad=True)
                      for a in (arrays[0], arrays[2], arrays[3]))
        nt = torch.from_numpy(arrays[1])
        y = fn(feat, nt, w, b)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        grads.append((y.detach(), feat.grad, w.grad, b.grad))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not grads[1][2][5].any()


def test_lattice_train_transform_matches_jax():
    """Fed the masks JAX drew from a key, the port's augmentation equals
    JAX's lattice_train_transform exactly."""
    g_j, g_t = _graphs(1)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jlat.lattice_train_transform(g_j, key)
        got = tlat.apply_train_masks(g_t, _torch_masks(_jax_masks(key, g_j)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not np.array_equal(np.asarray(want.emask), np.asarray(g_j.emask))


def test_train_masks_and_dropout_draw_from_the_generator():
    _, tm, _, _, g_t = _pair("heat4")
    for layer in range(2):
        getattr(tm, f"gcs_{layer}").dropout = 0.5
    tm.gcs_0.dropout = 0.5
    tm.train()
    with pytest.raises(ValueError, match="generator"):
        tm(g_t)
    state = torch.random.get_rng_state()
    out1 = tm(tlat.lattice_train_transform(
        g_t, torch.Generator().manual_seed(3)),
        generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(3)
    masks = tlat.draw_train_masks(g_t, gen)
    assert masks.keep_node.shape == (B, N) and masks.keep_col.shape == (D,)
    drop = tm.draw_dropout_masks(g_t, torch.Generator().manual_seed(4))
    assert len(drop) == 2 and drop[0].shape == (B * N, 16)
    out2 = tm(tlat.apply_train_masks(g_t, masks), drop_masks=drop)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)
    tm.eval()
    with torch.no_grad():
        assert torch.isfinite(tm(g_t)).all()


def _scores(tm, g):
    """The first HEAT layer's edge scores [B, N, k, H], from the port's
    own submodules, before the softmax."""
    b, n, k = g.idx.shape
    flat_ty = g.ntypes.reshape(-1)
    layer = tm.gcs_0
    d_k = layer.out_dim // layer.n_heads
    with torch.no_grad():
        h = tm.adapt_ws(g.feats.reshape(b * n, -1), flat_ty)
        q = layer.q_linears(h, flat_ty)[tlat._flat_dst(g)]
        kv = layer.k_linears(h, flat_ty).reshape(b, n, 1, layer.n_heads, d_k)
        ea = layer.e_linear(g.sim[..., None])
        return (q.reshape(b, n, k, layer.n_heads, d_k) * kv).sum(-1) * ea \
            / np.sqrt(d_k)


@pytest.mark.parametrize("seed,ea_scale", [(0, 8.0), (2, 12.0)])
def test_shifted_softmax_gradients_match_jax(seed, ea_scale):
    """Scores past 0.9 * 60 take the per-destination shift in both
    packages; the gradients of every parameter agree with JAX's. A large
    shared key bias and a constant edge weight make the scores large but
    close together at each destination, so no softmax group sits at the
    clamp, where JAX's own backward is not finite (its division
    gradient squares a denominator near e^-60, which underflows)."""
    g_j, g_t = _graphs(seed)
    kw = dict(in_dim=D, hidden_dim=16, out_dim=2, n_layers=1, n_heads=1,
              n_node_types=T, dropout=0.0)
    jm = jlat.HEATNet4Lattice(**kw)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), g_j)["params"])
    layer = params["gcs_0"]
    layer["e_linear"]["kernel"] = np.zeros_like(layer["e_linear"]["kernel"])
    layer["e_linear"]["bias"] = np.full_like(layer["e_linear"]["bias"],
                                             ea_scale)
    layer["k_linears"]["bias"] = np.full_like(layer["k_linears"]["bias"], 20.0)
    tm = convert.load_flax_variables(tlat.HEATNet4Lattice(**kw),
                                     {"params": params})
    score = _scores(tm, g_t)
    assert score[g_t.emask].abs().max() > 0.9 * 60

    labels, weights = np.array([0, 1]), np.array([1.0, 1.0], np.float32)
    jloss = jax_parse_loss({"loss": "CE"})
    want = jax.jit(jax.grad(lambda p: jloss(jm.apply({"params": p}, g_j),
                                            jnp.asarray(labels),
                                            jnp.asarray(weights))))(params)
    tm.train()
    parse_loss({"loss": "CE"})(tm(g_t), torch.from_numpy(labels),
                               torch.from_numpy(weights)).backward()
    got = _flat(convert.params_to_flax(tm, {n: p.grad for n, p in
                                            tm.named_parameters()}))
    want = _flat(jax.tree.map(np.asarray, dict(want)))
    assert np.abs(want["gcs_0/q_linears/kernel"]).max() > 1e-5
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=1e-4 * np.abs(want[name]).max() + 1e-7,
                                   err_msg=name)


def test_shift_is_a_constant_for_autograd():
    """Destination 0 takes three edges: one alone in its softmax group at
    score 100 (the destination's max) and a group of two at 41 and 38.5,
    59 and 61.5 below it, so the second is clamped and the group
    straddles the clamp. With the shift held constant (JAX's
    stop_gradient) the lone edge gets no gradient and the pair gets the
    clamped softmax's; a shift that carried a gradient would hand the
    max edge minus the pair's sum. Reference: the same softmax written
    out in float64 with the shift as a plain number."""
    idx = torch.tensor([[[1], [0], [0], [0]]])
    esign = torch.tensor([[[1], [1], [1], [0]]])
    g = tlat.LatticeGraph(torch.zeros(1, 4, 2), torch.zeros(1, 4, dtype=torch.long),
                          torch.ones(1, 4, dtype=torch.bool), idx,
                          torch.zeros(1, 4, 1), esign,
                          torch.ones(1, 4, 1, dtype=torch.bool))
    s0 = [[[[0.5, 0.0]], [[41.0, 1.0]], [[38.5, -2.0]], [[100.0, 3.0]]]]
    upstream = torch.tensor([[[[0.3, -0.7]], [[1.0, 0.4]], [[-2.0, 0.9]],
                              [[0.5, 1.5]]]], dtype=torch.float64)

    score = torch.tensor(s0, requires_grad=True)
    attn = tlat.edge_softmax(g, score, T)
    (attn * upstream.float()).sum().backward()

    ref_score = torch.tensor(s0, dtype=torch.float64, requires_grad=True)
    # one shift per destination, the max over its edges and heads; head 1
    # of destination 0 then sits wholly at the clamp (uniform weights)
    shift = torch.tensor([0.5, 100.0, 100.0, 100.0],
                         dtype=torch.float64).reshape(1, 4, 1, 1)
    ex = torch.exp((ref_score - shift).clamp(-60.0, 60.0))
    groups = [[0], [1, 2], [3]]  # (dst 1), (dst 0, esign 1), (dst 0, esign 0)
    ref = torch.zeros_like(ex)
    for grp in groups:
        ref[0, grp] = ex[0, grp] / ex[0, grp].sum(0, keepdim=True)
    (ref * upstream).sum().backward()

    torch.testing.assert_close(attn.double(), ref.detach(), rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(score.grad.double(), ref_score.grad,
                               rtol=1e-4, atol=1e-6)
    assert score.grad[0, 3].abs().max() == 0
    assert ref_score.grad[0, 1, 0, 0].abs() > 0.1


# (model, optimizer, lr, loss): every optimizer branch with both models
# and both losses. Adam's lr is 1e-4: Adam divides each gradient by its
# own running RMS, so a parameter whose gradient sits near f32 rounding
# (the q and k biases at init, ~1e-8, beside eps 1e-8) steps about +-lr
# on the sign of rounding noise, and at lr 1e-3 twenty such steps drift
# up to 4e-4 apart between any two f32 implementations.
LOCKSTEP = [
    ("heat4", "ADAM", 1e-4, "CE"), ("heat2", "ADAM", 1e-4, "BCE"),
    ("heat4", "adagrad", 1e-2, "CE"), ("heat2", "adagrad", 1e-2, "BCE"),
    ("heat4", "adadelta", 1.0, "BCE"), ("heat2", "adadelta", 1.0, "CE"),
    ("heat4", "SGD", 0.1, "BCE"), ("heat2", "SGD", 0.1, "CE"),
]


@pytest.mark.parametrize("which,method,lr,loss_name", LOCKSTEP)
def test_lockstep_training_matches_jax(which, method, lr, loss_name):
    """20 lattice training steps per package from the same weights over
    two alternating batches (one with a zero-weight tail slide), the
    augmentation masks shared, dropout 0: the loss trajectories agree to
    atol 5e-5 / rtol 1e-4 and the final parameters to atol 1e-4."""
    jm, tm, params, g0_j, g0_t = _pair(which, seed=0)
    g1_j, g1_t = _graphs(1)
    batches = [(g0_j, g0_t, np.array([0, 1]), np.array([1.0, 1.0])),
               (g1_j, g1_t, np.array([1, 0]), np.array([1.0, 0.0]))]
    config_optim = {"opt_method": method, "lr": lr, "weight_decay": 5e-3}
    tx = jax_parse_optimizer(config_optim)
    jloss = jax_parse_loss({"loss": loss_name})

    @jax.jit
    def jax_step(params, opt_state, g, key, labels, weights):
        g = jlat.lattice_train_transform(g, key)

        def loss_fn(p):
            logits = jm.apply({"params": p}, g, train=True)
            return jloss(logits, labels, weights)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree.map(lambda p, u: p + u, params, updates), opt_state, loss

    opt = parse_optimizer(config_optim, tm.parameters())
    tloss = parse_loss({"loss": loss_name})
    opt_state = tx.init(params)
    j_losses, t_losses = [], []
    for step in range(20):
        g_j, g_t, labels, weights = batches[step % 2]
        key = jax.random.PRNGKey(100 + step)
        params, opt_state, loss = jax_step(
            params, opt_state, g_j, key, jnp.asarray(labels),
            jnp.asarray(weights, jnp.float32))
        j_losses.append(float(loss))
        loss_t, prob = lattice_train_step(
            tm, opt, tloss, g_t, torch.from_numpy(labels),
            torch.from_numpy(weights.astype(np.float32)),
            masks=_torch_masks(_jax_masks(key, g_j)))
        t_losses.append(float(loss_t))
        assert prob.shape == (B, 2)
    np.testing.assert_allclose(t_losses, j_losses, atol=5e-5, rtol=1e-4)
    assert np.ptp(j_losses) > 1e-3
    _assert_params_close(params, tm, atol=1e-4)
