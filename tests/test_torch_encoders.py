"""Port parity of the construction CNNs beside KimiaNet
(wsi_hgnn_tpu_torch/models/featurizers/{hovernet,efficientnet,effnetv2,
convert,__init__}.py) against the JAX package on the CPU, at full widths:
HoVer-Net with its tp/np/hv branches and fc1 (at 16 features: fc1 is
[1048576, 16]), EfficientNet-B4 and EffNetV2-S, their reference-checkpoint
key maps and HoVer-Net's fc1 handling. Weights are seeded numpy trees with
every leaf away from its init, so each one carries information. The
encoders built from weight files and construction with the two shipped
configs that name them are test_torch_construct_encoders.py.

Tolerances: f32 through about 100 convolutions summed in another order,
rtol 1e-3 / atol 1e-4 on maps and EfficientNet features (the HoVer-Net tp
tolerance of test_torch_hovernet.py); fc1 features to a relative L2 of
1e-4 (JAX sums 32 chunks of K = 32768); node types and graph indices
exactly."""
import math

import numpy as np
import pytest
import torch

import jax

from wsi_hgnn_tpu.models.featurizers import convert as jconvert
from wsi_hgnn_tpu.models.featurizers import effnetv2 as jv2
from wsi_hgnn_tpu.models.featurizers import efficientnet as jeff
from wsi_hgnn_tpu.models.featurizers import hovernet as jhv
from wsi_hgnn_tpu_torch import convert as bridge
from wsi_hgnn_tpu_torch.models.featurizers import (EfficientNet, EffNetV2,
                                                   HoVerNet, convert,
                                                   hovernet_full_apply,
                                                   load_cnn_variables,
                                                   load_hovernet)
from wsi_hgnn_tpu_torch.models.featurizers import efficientnet as teff
from wsi_hgnn_tpu_torch.models.featurizers import hovernet as thv

from test_torch_zoo import flat
import port_threads  # noqa: F401  (torch threads per test worker)

FEAT = 16              # HoVer-Net fc1 width here (the configs' 1024 is 4.3 GB)
MAP_TOL = dict(rtol=1e-3, atol=1e-4)


def rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / np.linalg.norm(np.asarray(want)))


def numpy_tree(module, seed):
    """A seeded numpy flax tree shaped like `module`'s: kernels normal at
    1/sqrt(fan-in), biases and means near 0, scales and variances near 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, a in flat(bridge.to_flax_variables(module)).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.standard_normal(a.shape).astype(np.float32)
            v *= np.float32(1.0 / math.sqrt(np.prod(a.shape[:-1])))
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        else:
            v = (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        node = out
        *dirs, name = key.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = v
    return out


# one seeded batch of patches for every forward below
PATCHES = np.random.RandomState(2).randint(0, 256, (2, 256, 256, 3)
                                           ).astype(np.uint8)
JAX_HOVER = jhv.HoVerNet(nr_types=6, mode="fast", feat_dim=FEAT)
JAX_EFF = jeff.EfficientNet.from_name("efficientnet-b4", num_classes=1024)


def unit(px):
    """uint8 -> f32 in [0, 1], the encoders' on-device scaling."""
    return px.astype(np.float32) / np.float32(255.0)


# the JAX functions the JAX encoders compose, jitted with the weights as
# arguments (a jit that closes over them embeds 60M constants and compiles
# for longer than it runs on the CPU)
jax_hover_full = jax.jit(
    lambda v, x: jhv.hovernet_full_apply(JAX_HOVER, v, x))
jax_typing = jax.jit(lambda v, x: jhv.hovernet_typing_apply(JAX_HOVER, v, x))
jax_eff = jax.jit(lambda v, x: JAX_EFF.apply(v, x))


# --------------------------------------------------------------------- #
# HoVer-Net, the full net
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def hover_full():
    """A full HoVer-Net tree (tp/np/hv, fc1 at FEAT), one 256x256 patch,
    and one JAX forward of the whole net on the constructor's orientation:
    (tree, patch, {branch: map}, fc1 features, node types)."""
    tree = numpy_tree(HoVerNet(6, "fast", feat_dim=FEAT), 1)
    x = unit(PATCHES[:1])

    @jax.jit
    def forward(v, imgs):
        out, feats = JAX_HOVER.apply(v, jhv._constructor_orientation(imgs))
        return out, feats, jhv.node_types_on_device(out["tp"])

    out, feats, types = forward(tree, x)
    return (tree, x, {k: np.asarray(v) for k, v in out.items()},
            np.asarray(feats), np.asarray(types))


def test_hovernet_full_matches_jax(hover_full):
    """tp/np/hv maps (164x164 in fast mode) to rtol 1e-3 / atol 1e-4, fc1
    features to a relative L2 of 1e-4 and node types exactly, all from the
    H/W-swapped patch; hovernet_full_apply gives the same features and
    types as the module's own forward."""
    tree, x, maps, feats, types = hover_full
    model = load_hovernet(HoVerNet(6, "fast", feat_dim=FEAT), tree, 0).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, f_mod = model(thv._constructor_orientation(xt).permute(0, 3, 1, 2))
        f, t = hovernet_full_apply(model, xt)
    assert sorted(out) == ["hv", "np", "tp"]
    for name, want in maps.items():
        got = out[name].permute(0, 2, 3, 1).numpy()
        assert got.shape == (1, 164, 164, 6 if name == "tp" else 2)
        np.testing.assert_allclose(got, want, **MAP_TOL, err_msg=name)
    assert f.dtype == torch.float32 and f.shape == (1, FEAT)
    assert rel_l2(f.numpy(), feats) <= 1e-4
    np.testing.assert_array_equal(f.numpy(), f_mod.numpy())
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), types)
    np.testing.assert_array_equal(
        thv.node_types_from_tp(out["tp"].permute(0, 2, 3, 1).numpy()),
        jhv.node_types_from_tp(maps["tp"]))


def test_fc1_reorder_matches_a_linear_over_the_nchw_flatten():
    """The reference's fc1 is an nn.Linear over torch's NCHW flatten of
    the 32x32x1024 bottleneck; after hovernet_torch_to_flax (columns
    reordered to the NHWC flatten) feature_head gives what that Linear
    gives, the JAX converter writes the same kernel, and
    hovernet_state_dict writes the Linear's weight back."""
    rng = np.random.RandomState(3)
    lin = torch.nn.Linear(thv.FC1_IN, FEAT)
    d3 = torch.from_numpy(rng.randn(2, 1024, 32, 32).astype(np.float32))
    sd = {"fc1.weight": lin.weight.detach().numpy(),
          "fc1.bias": lin.bias.detach().numpy()}
    tree = convert.hovernet_torch_to_flax(sd, 6)
    np.testing.assert_array_equal(
        tree["params"]["fc1"]["kernel"],
        jconvert.hovernet_torch_to_flax(sd, 6)["params"]["fc1"]["kernel"])
    net = HoVerNet(6, "fast", feat_dim=FEAT, branches=())
    bridge.load_flax_variables(net.fc1, {"params": tree["params"]["fc1"],
                                         "batch_stats": {}})
    with torch.no_grad():
        got = net.feature_head(d3)
        want = lin(d3.reshape(2, -1))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    back = convert.hovernet_state_dict(tree)
    np.testing.assert_array_equal(back["fc1.weight"], sd["fc1.weight"])
    np.testing.assert_array_equal(back["fc1.bias"], sd["fc1.bias"])


def test_fc1_is_filtered_for_typing_and_checked_for_the_full_net(
        tmp_path, capsys):
    """A HoVer-Net file that carries fc1 (the reference's own net saves
    it): the typing net takes every other leaf and no fc1, as the JAX
    typing loader does; the full net takes fc1 at its width and raises on
    another; without a file the full net's fc1 is seeded on its device."""
    typing = numpy_tree(HoVerNet.typing(6, "fast"), 4)
    sd = {k: torch.from_numpy(v)
          for k, v in convert.hovernet_state_dict(typing).items()}
    sd["fc1.weight"] = torch.zeros(4, 8)
    sd["fc1.bias"] = torch.zeros(4)
    path = tmp_path / "hover.tar"
    torch.save({"desc": sd}, path)
    got = load_cnn_variables("hover", HoVerNet.typing(6, "fast"), path, 0)
    assert "fc1" not in got["params"] and "decoder_np" not in got["params"]
    assert flat(got).keys() == flat(typing).keys()
    for k, v in flat(typing).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    assert f"hover weights: {path}" in capsys.readouterr().out
    head_only = dict(feat_dim=FEAT, branches=("tp",))
    with pytest.raises(ValueError, match="fc1 kernel"):
        load_cnn_variables("hover", HoVerNet(6, "fast", **head_only), path, 0)
    full = HoVerNet(6, "fast", **head_only)
    seeded = load_cnn_variables("hover", full, None, 0)
    assert "fc1" not in seeded["params"]
    load_hovernet(full, seeded, 7)
    with torch.no_grad():
        k = full.fc1.kernel.clone()
        again = thv.ChunkedDense(thv.FC1_IN, FEAT).seed_(7).kernel
        torch.testing.assert_close(k, again, rtol=0, atol=0)
        assert abs(float(k.std()) * math.sqrt(thv.FC1_IN) - 1.0) < 0.01
        assert float(full.fc1.bias.abs().max()) == 0.0


# --------------------------------------------------------------------- #
# EfficientNet-B4 and EffNetV2-S
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def effnet_tree():
    """A seeded EfficientNet-B4 tree with a 1024-way fc."""
    return numpy_tree(EfficientNet.from_name("efficientnet-b4", 1024), 5)


def test_efficientnet_b4_matches_jax(effnet_tree):
    """Full widths, batch 2, 256x256: both packages convert one seeded
    state dict under efficientnet_pytorch's names (written by
    efficientnet_state_dict, DataParallel-prefixed) to the same tree, and
    the features agree to rtol 1e-3 / atol 1e-4 (f32 through about 100
    convolutions)."""
    sd = {f"module.{k}": v
          for k, v in convert.efficientnet_state_dict(effnet_tree).items()}
    assert len([k for k in sd if k.endswith("_depthwise_conv.weight")]) == 32
    got_tree = convert.efficientnet_torch_to_flax(sd, num_classes=1024)
    want_tree = jconvert.efficientnet_torch_to_flax(sd, num_classes=1024)
    assert flat(got_tree).keys() == flat(want_tree).keys() \
        == flat(effnet_tree).keys()
    for k, v in flat(want_tree).items():
        np.testing.assert_array_equal(flat(got_tree)[k], v, err_msg=k)
    x = unit(PATCHES)
    want = np.asarray(jax_eff(want_tree, x))
    model = bridge.load_flax_variables(
        EfficientNet.from_name("efficientnet-b4", 1024), got_tree).eval()
    assert model.bn_stem.eps == 1e-3 and model.block0.se_reduce.out_channels \
        == int(48 * 0.25)
    with torch.no_grad():
        got = teff.efficientnet_apply(model, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, want, **MAP_TOL)


def test_efficientnet_static_padding_ladder():
    """Every conv's pads come from the native 380 px ladder, as the JAX
    module computes them: the stem and each block's depthwise conv; at the
    k=5/s=2 stage-3 conv the ladder is 95, so the pads are (2, 2) where
    dynamic SAME on a 256 input (map 64) would give (1, 2)."""
    for ladder in (380, 190, 95, 48, 24, 12, 64, 7):
        for k, s in ((3, 1), (3, 2), (5, 1), (5, 2)):
            assert teff.static_same_pad(ladder, k, s) == \
                jeff.static_same_pad(ladder, k, s)
    model = EfficientNet.from_name("efficientnet-b4", 8)
    assert model.stem_pad == jeff.static_same_pad(380, 3, 2)[0]
    ladder, pads = 190, []
    for (r, k, s, *_rest) in jeff._B0_BLOCKS:
        for j in range(jeff.round_repeats(r, 1.8)):
            stride = s if j == 0 else 1
            pads.append(jeff.static_same_pad(ladder, k, stride)[0])
            ladder = math.ceil(ladder / stride)
    assert [getattr(model, f"block{i}").dw_pad for i in range(32)] == pads
    assert ((2, 2), (2, 2)) in pads[:8] and model.n_blocks == 32
    assert teff.static_same_pad(64, 5, 2)[0] == ((1, 2), (1, 2))
    for f, w in ((32, 1.4), (1280, 1.4), (320, 1.4), (16, 1.0)):
        assert teff.round_filters(f, w) == jeff.round_filters(f, w)
    assert model.conv_head.out_channels == 1792
    assert model.conv_stem.out_channels == 48


def test_efficientnet_convert_skips_a_mismatched_fc():
    """The stock ImageNet file's 1000-way _fc is skipped for a 1024-d head
    (the reference's from_pretrained(num_classes=1024) re-inits it), a
    matching head converts, as in the JAX converter."""
    rng = np.random.RandomState(0)
    sd = {"_conv_stem.weight": rng.randn(48, 3, 3, 3).astype(np.float32),
          "_fc.weight": rng.randn(1000, 1792).astype(np.float32),
          "_fc.bias": rng.randn(1000).astype(np.float32)}
    for mod in (convert, jconvert):
        out = mod.efficientnet_torch_to_flax(sd, num_classes=1024)
        assert "fc" not in out["params"] and "conv_stem" in out["params"]
    sd["_fc.weight"] = rng.randn(1024, 1792).astype(np.float32)
    sd["_fc.bias"] = rng.randn(1024).astype(np.float32)
    got = convert.efficientnet_torch_to_flax(sd, num_classes=1024)
    want = jconvert.efficientnet_torch_to_flax(sd, num_classes=1024)
    assert got["params"]["fc"]["kernel"].shape == (1792, 1024)
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)


def test_effnetv2_s_matches_jax():
    """EffNetV2-S (exported by both packages, used by no config) at 64x64,
    batch 1, to rtol 1e-3 / atol 1e-4."""
    model = EffNetV2.s(num_classes=10)
    tree = numpy_tree(model, 8)
    x = np.random.RandomState(9).rand(1, 64, 64, 3).astype(np.float32)
    jmodel = jv2.EffNetV2.s(num_classes=10)
    want = np.asarray(jax.jit(lambda v, imgs: jmodel.apply(v, imgs))(tree, x))
    bridge.load_flax_variables(model, tree).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (1, 10)
    np.testing.assert_allclose(got, want, **MAP_TOL)
