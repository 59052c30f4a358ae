"""Port parity of SimCLR's training half (wsi_hgnn_tpu_torch/models/mil/
simclr.py, tools/pretrain_simclr.py) against the JAX package on the CPU.

Tolerances: `nt_xent_loss` within 1e-6 relative; `augment_pair` on JAX's
own draws (crop offsets, flips, brightness) within 1e-5, the 204 -> 256
bilinear resize's edges included; the LR schedule exactly equal (JAX in
float64); a 5-step lockstep of the frozen-backbone step, where only fc_4
trains (coupled L2 then Adam, the views drawn by JAX and fed to the
port): the tiny encoder in float64 within 1e-7 (losses 1e-9), KimiaNet at
32 x 32 x 2 images in f32 (the port's fused chain against the flax
module) with losses within 1e-5 relative and fc_4's distance from JAX's
within 1e-3 of how far JAX's fc_4 moved (L2 per leaf: f32 rounding of
the features can move Adam's normalised update of a near-zero gradient
entry by a good part of a step, so no elementwise bound holds)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tools import pretrain_simclr as jtool
from wsi_hgnn_tpu.models.mil import simclr as jsim
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.models.mil import simclr as tsim
from wsi_hgnn_tpu_torch.tools import pretrain_simclr as ttool
import port_threads  # noqa: F401  (torch threads per test worker)


def jax_views(key, b, h, w, crop_frac=0.8):
    """The draws jsim.augment_pair(key, images) makes, as the port's two
    view dicts (its key splits, step for step)."""
    ch, cw = int(h * crop_frac), int(w * crop_frac)

    def one(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return dict(
            top=torch.from_numpy(np.array(
                jax.random.randint(k1, (b,), 0, h - ch + 1))).long(),
            left=torch.from_numpy(np.array(
                jax.random.randint(k2, (b,), 0, w - cw + 1))).long(),
            flip=torch.from_numpy(np.array(
                jax.random.bernoulli(k3, 0.5, (b,)))),
            bright=torch.from_numpy(np.array(jax.random.uniform(
                k4, (b, 1, 1, 1), minval=0.8, maxval=1.2)).reshape(b)))
    ka, kb = jax.random.split(key)
    return one(ka), one(kb)


def images(b, size, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).rand(b, size, size, 3).astype(dtype)


@pytest.mark.parametrize("b,temp", [(4, 0.5), (7, 0.1)])
def test_nt_xent_matches_jax(b, temp):
    rng = np.random.RandomState(b)
    z1, z2 = rng.randn(b, 9).astype(np.float32), rng.randn(b, 9).astype(
        np.float32)
    want = float(jsim.nt_xent_loss(jnp.asarray(z1), jnp.asarray(z2), temp))
    got = float(tsim.nt_xent_loss(torch.from_numpy(z1), torch.from_numpy(z2),
                                  temp))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("size", [256, 30])
def test_augment_pair_on_jax_draws_matches_jax(size):
    """Crop (offsets up to the border), flip, brightness and the clip;
    at 256 the crop is 204 x 204, resized back to 256 x 256."""
    imgs = images(3, size)
    key = jax.random.PRNGKey(size)
    want = jsim.augment_pair(key, jnp.asarray(imgs))
    views = jax_views(key, 3, size, size)
    got = tsim.augment_pair(torch.from_numpy(imgs), views=views)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the port's own draws: deterministic from a generator, in range
    gen = torch.Generator().manual_seed(0)
    a = tsim.augment_pair(torch.from_numpy(imgs), gen)
    b = tsim.augment_pair(torch.from_numpy(imgs),
                          torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert 0.0 <= float(a[0].min()) and float(a[0].max()) <= 1.0


def test_bilinear_resize_matches_jax_image_resize():
    """The crop resize alone, edges included."""
    x = np.random.RandomState(1).rand(1, 204, 204, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x[0]), (256, 256, 3), "bilinear")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(256, 256),
        mode="bilinear", align_corners=False, antialias=False
    ).permute(0, 2, 3, 1)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_lr_schedule_equals_jax():
    for args in ((1e-5, 20, 3, 10), (2e-4, 7, 5, 1), (1e-3, 3, 1, 0)):
        t = ttool.simclr_lr_schedule(*args)
        with jax.enable_x64(True):
            j = jtool.simclr_lr_schedule(*args)
            for c in range((args[1] + args[3] + 3) * args[2]):
                assert t(c) == float(j(c)), (args, c)


def _jax_lockstep(jmodel, variables, imgs, lr, wd, steps, x64):
    """The JAX tool's frozen-backbone step, `steps` times: (losses, final
    fc_4 params, each step's view draws as the port takes them)."""
    bstats = variables.get("batch_stats", {})

    def encoder_apply(p, v):
        return jmodel.apply({"params": p, **({"batch_stats": bstats}
                                             if bstats else {})},
                            v, train=False)[1]

    def label(p):
        return jax.tree.map_with_path(
            lambda kp, _: "train" if kp[0].key == "fc_4" else "freeze", p)

    adam = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(),
                       optax.scale_by_learning_rate(lr))
    tx = optax.multi_transform({"train": adam, "freeze": optax.set_to_zero()},
                               label)
    step = jsim.make_simclr_train_step(encoder_apply, tx)
    params = variables["params"]
    state = tx.init(params)
    losses, views = [], []
    key = jax.random.PRNGKey(9)
    b, size = imgs.shape[:2]
    for _ in range(steps):
        key, k = jax.random.split(key)
        k_aug = jax.random.split(k, 3)[0]
        views.append(jax_views(k_aug, b, size, size))
        params, state, loss = step(params, state, k, jnp.asarray(imgs))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params["fc_4"]), views


@pytest.mark.parametrize("backbone", ["tiny", "kimia"])
def test_frozen_backbone_lockstep_matches_jax(backbone):
    steps, lr, wd = 5, 1e-3, 1e-5
    x64 = backbone == "tiny"
    size = 32
    tm, _ = ttool.build_model(backbone, 16)
    convert.init_flax_like_(tm, 2)
    variables = convert.to_flax_variables(tm)
    jmodel, _ = jtool.build_model(backbone, 16)
    imgs = images(2, size, seed=3, dtype=np.float64 if x64 else np.float32)
    with jax.enable_x64(x64):
        jv = jax.tree.map(lambda a: jnp.asarray(
            a, jnp.float64 if x64 else jnp.float32), variables)
        want_l, want_fc, views = _jax_lockstep(jmodel, jv, imgs, lr, wd,
                                               steps, x64)
    if x64:
        tm.double()
    project, trained = ttool.make_projector(tm, backbone, False,
                                            torch.device("cpu"))
    assert [id(p) for p in trained] == [id(p) for p in tm.fc_4.parameters()]
    opt = torch.optim.Adam(trained, lr=lr, weight_decay=wd)
    backbone_before = {n: p.detach().clone() for n, p in tm.named_parameters()
                       if not n.startswith("fc_4")}
    got_l = [float(tsim.simclr_train_step(
        project, opt, torch.from_numpy(imgs), views=v)) for v in views]
    for n, p in tm.named_parameters():
        if not n.startswith("fc_4"):
            assert torch.equal(p, backbone_before[n]), n
    got_fc = convert.to_flax_variables(tm)["params"]["fc_4"]
    if x64:
        np.testing.assert_allclose(got_l, want_l, rtol=1e-9)
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(got_fc[k], want_fc[k], rtol=1e-7,
                                       atol=1e-7 * np.abs(want_fc[k]).max())
    else:
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
        for k in ("kernel", "bias"):
            moved = np.linalg.norm(want_fc[k] - variables["params"]["fc_4"][k])
            diff = np.linalg.norm(got_fc[k] - want_fc[k])
            assert diff <= 1e-3 * moved, (k, diff, moved)


def test_jax_init_tree_shapes_equal_port():
    """Both backbones: the port's module holds the leaves flax's init
    draws, so best.pkl crosses."""
    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: tuple(v.shape)})
        return out

    for backbone in ("tiny", "kimia"):
        tm, _ = ttool.build_model(backbone, 16)
        jm, _ = jtool.build_model(backbone, 16)
        want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 32, 32, 3))))
        got = flat(convert.to_flax_variables(tm))
        assert got == flat(want), backbone
