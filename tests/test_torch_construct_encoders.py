"""Port parity of the 'hover' and 'efficientnet-b4' construction encoders
built from weight files (wsi_hgnn_tpu_torch/models/featurizers/__init__.py,
pipeline/construct.py, get_graph.py) against the JAX package on the CPU:
the encoders on one patch, and `get_graph` with the two shipped configs
that name them, against the JAX package's construct_all. Weight files are
written under the reference's key names from seeded numpy trees
(test_torch_encoders.numpy_tree); HoVer-Net's fc1 is 16 wide here (the
configs' 1024 is a 4.3 GB kernel).

Tolerances as in test_torch_encoders.py: fc1 features to a relative L2 of
1e-4, EfficientNet features and sims to rtol 1e-3 / atol 1e-4, node types
and graph indices exactly."""
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import wsi_hgnn_tpu.models.featurizers as jfeat
from wsi_hgnn_tpu.models.featurizers import convert as jconvert
from wsi_hgnn_tpu.pipeline import construct as jconstruct
from wsi_hgnn_tpu_torch import get_graph
from wsi_hgnn_tpu_torch.config import load_config
from wsi_hgnn_tpu_torch.models.featurizers import (EfficientNet, HoVerNet,
                                                   convert, make_cnn_encoder)
from wsi_hgnn_tpu_torch.pipeline import construct

from test_torch_encoders import (FEAT, MAP_TOL, PATCHES, jax_eff,
                                 jax_hover_full, jax_typing, numpy_tree,
                                 rel_l2, unit)
from test_torch_zoo import flat
import port_threads  # noqa: F401  (torch threads per test worker)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {"hover": "COAD_Hovernet_graph_constructor.yml",
           "efficientnet-b4": "BRCA_HovernetEfficient_graph_constructor.yml"}
SLIDE = "TCGA-AA-0001-01Z-00-DX1"


# --------------------------------------------------------------------- #
# the encoders from weight files, and construction with the two configs
# --------------------------------------------------------------------- #
def slide_config(name, root: Path):
    """The shipped config of encoder `name` with its paths redirected
    under `root`, where the weight files are written ('hover' at FEAT
    features, one chunk of 3 patches per slide)."""
    cfg = load_config(ROOT / "configs" / "GraphConstruction" / CONFIGS[name])
    gcfg, hcfg, kcfg = (dict(cfg["graph_constructor"]),
                        dict(cfg["hovernet_config"]),
                        dict(cfg["kimianet_config"]))
    assert gcfg["encoder_name"] == name and gcfg["node_type_dir"] is None
    gcfg.update(patch_path=str(root / "patches") + "/",
                out_dir=str(root / "graphs" / name),
                efficientnet_model_path=str(root / "efficientnet-b4.pth"))
    if name == "hover":
        gcfg["feature_dim"] = FEAT
    hcfg.update(hovernet_model_path=str(root / "hovernet.tar"), batch_size=3)
    kcfg.update(kimianet_model_path=str(root / "absent.pth"))
    return gcfg, hcfg, kcfg


def yaml_value(v):
    return "" if v is None else f"'{v}'" if isinstance(v, str) else v


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """Weight files (a HoVer-Net tar with tp/np/hv and fc1 at FEAT over the
    NCHW flatten, an EfficientNet-B4 .pth), a 3-patch slide, and per
    encoder name: (graph config, hovernet config, kimianet config, the
    port's encoder, the JAX encoder), both built from the files. The JAX
    encoder is the JAX package's: its converters read the files, its
    `_make_encode` pads every chunk to the slide's 3 patches (one compiled
    program per encoder), and its apply functions run
    (hovernet_full_apply; EfficientNet with hovernet_typing_apply)."""
    root = tmp_path_factory.mktemp("encoders")
    hover_tree = numpy_tree(HoVerNet(6, "fast", feat_dim=FEAT), 21)
    effnet_tree = numpy_tree(EfficientNet.from_name("efficientnet-b4", 1024),
                             22)
    hpath, epath = root / "hovernet.tar", root / "efficientnet-b4.pth"
    torch.save({"desc": {k: torch.from_numpy(v) for k, v in
                         convert.hovernet_state_dict(hover_tree).items()}},
               hpath)
    torch.save({k: torch.from_numpy(v) for k, v in
                convert.efficientnet_state_dict(effnet_tree).items()}, epath)
    d = root / "patches" / "tumor" / SLIDE
    d.mkdir(parents=True)
    for i, px in enumerate(np.random.RandomState(10).randint(
            0, 256, (3, 256, 256, 3)).astype(np.uint8)):
        Image.fromarray(px).save(d / f"{i:03d}_0.png")

    # every leaf of each file converts, so the converted trees are the
    # JAX encoders' variables (the overlay onto their init replaces all)
    hover = jconvert.hovernet_torch_to_flax(
        jconvert.load_torch_state_dict(hpath), 6)
    eff = jconvert.efficientnet_torch_to_flax(
        jconvert.load_torch_state_dict(epath), num_classes=1024)
    assert flat(hover).keys() == flat(hover_tree).keys()
    assert flat(eff).keys() == flat(effnet_tree).keys()
    jax_encoders = {
        "hover": jfeat._make_encode(
            lambda px: jax_hover_full(hover, unit(px)), 1, 3),
        "efficientnet-b4": jfeat._make_encode(
            lambda px: (jax_eff(eff, unit(px)), jax_typing(hover, unit(px))),
            1, 3)}
    out = {}
    for name in CONFIGS:
        gcfg, hcfg, kcfg = slide_config(name, root)
        port = make_cnn_encoder(name, gcfg, hcfg, kcfg,
                                with_typing=name != "hover", device="cpu")
        out[name] = (gcfg, hcfg, kcfg, port, jax_encoders[name])
    return root, out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_from_weight_files_matches_jax(encoders, name):
    """make_cnn_encoder('hover') and ('efficientnet-b4', with typing),
    built from the weight files the configs name, equal the JAX encoders
    of the same files on one patch: 'hover' fc1 features to a relative L2
    of 1e-4, EfficientNet features to rtol 1e-3 / atol 1e-4, node types
    exactly."""
    _, by_name = encoders
    _, _, _, port, jenc = by_name[name]
    f_t, t_t = port(PATCHES[:1])
    f_j, t_j = jenc(PATCHES[:1])
    assert f_t.shape == (1, FEAT if name == "hover" else 1024)
    if name == "hover":
        assert rel_l2(f_t, f_j) <= 1e-4
    else:
        np.testing.assert_allclose(f_t, np.asarray(f_j), **MAP_TOL)
    np.testing.assert_array_equal(t_t, np.asarray(t_j))
    assert set(port.stages) == ({"hovernet"} if name == "hover"
                                else {"efficientnet", "hovernet"})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_get_graph_with_the_config_matches_jax(encoders, name, tmp_path,
                                               capsys):
    """`python -m wsi_hgnn_tpu_torch.get_graph -config <the shipped yml,
    paths redirected> --construct -device cpu` builds its encoder from the
    config (the weight files it names load, typing inline for
    'efficientnet-b4') and writes the graphs the JAX package's
    construct_all writes with the JAX encoder of the same files: features
    to the tolerances above, node types and edge indices exactly (3
    patches: every row's neighbours are the others, no f32 ties). The
    port runs the config's `knn_impl: pallas` (the CUDA kernel's plain
    version here), the JAX side its exact KNN."""
    root, by_name = encoders
    gcfg, hcfg, kcfg, _, jenc = by_name[name]
    # the JAX side on its exact KNN: the JAX Pallas kernel repeats the last
    # real neighbour on a slide of fewer than k + 1 patches (k = 8 here),
    # where the exact path and the port's KNN drop them
    jcfg = dict(gcfg, out_dir=str(tmp_path / "jax"), knn_impl="exact")
    assert jconstruct.construct_all(jcfg, hcfg, kcfg, encoder=jenc,
                                    verbose=False) == 1
    text = "".join(
        f"{sec}:\n" + "".join(f"  {k}: {yaml_value(v)}\n"
                              for k, v in d.items())
        for sec, d in (("graph_constructor", gcfg), ("hovernet_config", hcfg),
                       ("kimianet_config", kcfg)))
    (tmp_path / "g.yml").write_text(text)
    get_graph.main(["-config", str(tmp_path / "g.yml"), "--construct",
                    "-device", "cpu"])
    log = capsys.readouterr().out
    assert f"hover weights: {hcfg['hovernet_model_path']}" in log
    if name != "hover":
        assert f"efficientnet weights: {gcfg['efficientnet_model_path']}" \
            in log
    for kind in ("heterogeneous", "homogeneous"):
        got = np.load(Path(gcfg["out_dir"]) / kind / f"{SLIDE}.npz")
        want = np.load(tmp_path / "jax" / kind / f"{SLIDE}.npz")
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            if key == "feat" and name == "hover":
                assert rel_l2(got[key], want[key]) <= 1e-4
            elif key in ("feat", "sim"):
                np.testing.assert_allclose(got[key], want[key], **MAP_TOL,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
    np.testing.assert_array_equal(
        np.load(Path(gcfg["out_dir"]) / "node_types" / f"{SLIDE}.npy"),
        np.load(tmp_path / "jax" / "node_types" / f"{SLIDE}.npy"))


def test_efficientnet_b7_raises_as_in_jax(tmp_path):
    """The one shipped config the JAX package cannot build
    (COAD_HoverEfficient_graph_constructor.yml, 'efficientnet-b7') raises
    NotImplementedError in both packages' encoder registries, and the
    port's construction raises before its first slide."""
    cfg = load_config(ROOT / "configs" / "GraphConstruction" /
                      "COAD_HoverEfficient_graph_constructor.yml")
    gcfg = dict(cfg["graph_constructor"], out_dir=str(tmp_path / "g"))
    assert gcfg["encoder_name"] == "efficientnet-b7"
    for mod, kw in ((construct, {"device": "cpu"}), (jconstruct, {})):
        with pytest.raises(NotImplementedError, match="efficientnet-b7"):
            mod.make_encoder("efficientnet-b7", gcfg, {}, {}, **kw)
    with pytest.raises(NotImplementedError, match="efficientnet-b7"):
        construct.construct_all(gcfg, {}, {}, device="cpu")
