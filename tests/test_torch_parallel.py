"""Data parallelism in the port (wsi_hgnn_tpu_torch/parallel/{mesh,dp}.py,
the sharded encoders of models/featurizers and pipeline/construct.py)
against the JAX package on the CPU.

The data-parallel steps run in one gloo world of 4 processes, each rank
building its own bucket from its row of the same stacked numpy batch;
the JAX package's `make_dp_train_step` runs the same 4 buckets over its
4-device CPU mesh from the same weights. Parameters after one step to
rtol 1e-4 / atol 1e-6 (tests/test_parallel.py's tolerance). The
featurizer tests run in this process over a device list that repeats the
CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu.config import parse_lattice_twin as jax_parse_lattice_twin
from wsi_hgnn_tpu.config import parse_loss as jax_parse_loss
from wsi_hgnn_tpu.config import parse_optimizer as jax_parse_optimizer
from wsi_hgnn_tpu.graph.build import build_batch_device as jax_build_batch
from wsi_hgnn_tpu.models.lattice import build_lattice_device as jax_build_lat
import wsi_hgnn_tpu.models.featurizers as jfeat
from wsi_hgnn_tpu.models.featurizers import convert as jconvert
from wsi_hgnn_tpu.parallel import (make_dp_featurizer as jax_make_dp_featurizer,
                                   make_dp_lattice_train_step as jax_dp_lat,
                                   make_dp_train_step as jax_dp_step,
                                   make_mesh as jax_make_mesh,
                                   make_sharded_batch_apply as
                                   jax_make_sharded_batch_apply,
                                   place_state as jax_place_state,
                                   shard_stacked as jax_shard_stacked)
from wsi_hgnn_tpu.train.trainer import TrainState
from wsi_hgnn_tpu_torch import collectives, convert
from wsi_hgnn_tpu_torch.config import parse_gnn_model, parse_lattice_twin
from wsi_hgnn_tpu_torch.models.featurizers import make_cnn_encoder
from wsi_hgnn_tpu_torch.parallel import (make_dp_featurizer,
                                         make_sharded_batch_apply,
                                         stack_graphs)
from wsi_hgnn_tpu_torch.pipeline import construct

import port_threads  # noqa: F401  (torch threads per test worker)
import port_worlds

WORLD = 4
CPU = torch.device("cpu")
OPTIM = {"opt_method": "ADAM", "lr": 0.001, "weight_decay": 0.0}
# GIN's MLP biases ahead of a BatchNorm have a gradient of 0 in exact
# arithmetic (f32 noise in either package), which Adam's first step would
# scale up to lr: its case updates by SGD, linear in the gradient
SGD = {"opt_method": "SGD", "lr": 0.01, "weight_decay": 0.0}
HEAT2 = {"name": "HEAT2", "n_node_types": 6, "num_layers": 1, "in_dim": 8,
         "hidden_dim": 16, "out_dim": 2, "n_heads": 2, "feat_drop": 0.0,
         "graph_pooling_type": "mean"}
HEAT4 = dict(HEAT2, name="HEAT4")
GIN = {"name": "GIN", "in_dim": 8, "hidden_dim": 16, "out_dim": 2,
       "num_layers": 2, "num_mlp_layers": 2, "feat_drop": 0.0,
       "graph_pooling_type": "sum", "neighbor_pooling_type": "sum",
       "learn_eps": False}
# (GNN section, lattice form, n, seed, weights per rank, optimizer)
DP_CASES = {
    "heat2": (HEAT2, False, 32, 1, None, OPTIM),
    # ranks carry different weight sums: padding graphs of weight 0
    "heat2_uneven": (HEAT2, False, 32, 1,
                     [[1.0, 1.0], [1.0, 0.0], [0.0, 0.0], [1.0, 1.0]], OPTIM),
    "lattice": (HEAT4, True, 32, 3, None, OPTIM),
    "gin_bn": (GIN, False, 24, 3, None, SGD),
}


def dp_inputs(name):
    gnn, lattice, n, seed, w, optim = DP_CASES[name]
    rng = np.random.RandomState(seed)
    b, d = 2, 8
    n_types = 1 if gnn["name"] == "GIN" else 6
    feats = rng.randn(WORLD, b, n, d).astype(np.float32)
    ntypes = rng.randint(0, n_types, (WORLD, b, n)).astype(np.int64)
    labels = rng.randint(0, 2, (WORLD, b))
    weights = (np.ones((WORLD, b), np.float32) if w is None
               else np.asarray(w, np.float32))
    model = (parse_lattice_twin(gnn) if lattice else parse_gnn_model(gnn)[0])
    variables = jax.tree.map(np.copy, convert.to_flax_variables(
        convert.init_flax_like_(model, seed)))
    return {"config": {"GNN": gnn, "optimizer": optim,
                       "train": {"loss": "CE"}},
            "lattice": lattice, "variables": variables, "feats": feats,
            "ntypes": ntypes, "mask": np.ones((WORLD, b, n), bool),
            "labels": labels, "weights": weights, "radius": 4,
            "n_types": n_types, "augment": False}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [(f"dp/{name}", port_worlds.dp_step, dp_inputs(name))
             for name in DP_CASES]
    results = port_worlds.run_world(port_worlds.run_cases, WORLD,
                                    tmp_path_factory.mktemp("world"), cases)
    return {name: inp for name, _, inp in cases}, results


def jax_dp(inp):
    """The JAX package's DP step over its 4-device mesh on the same
    buckets: (loss, params, batch_stats) after it."""
    gnn = inp["config"]["GNN"]
    tx = jax_parse_optimizer(inp["config"]["optimizer"])
    loss_fcn = jax_parse_loss({"loss": "CE"})
    mesh = jax_make_mesh(WORLD)
    f, t, m = (jnp.asarray(inp[k]) for k in ("feats", "ntypes", "mask"))
    if inp["lattice"]:
        model = jax_parse_lattice_twin(gnn)
        graphs = jax.vmap(lambda a, b, c: jax_build_lat(
            a, b.astype(jnp.int32), c, 4, 6))(f, t, m)
        step = jax_dp_lat(model, tx, loss_fcn, mesh, augment=False)
    else:
        model, hetero = jax_parse_gnn_model(gnn)
        graphs = jax.vmap(lambda a, b, c: jax_build_batch(
            a, b.astype(jnp.int32), c, 4, inp["n_types"],
            add_self_loops=not hetero))(f, t, m)
        step = jax_dp_step(model, tx, loss_fcn, hetero, mesh, augment=False)
    variables = jax.tree.map(jnp.asarray, inp["variables"])
    state = TrainState(
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(42),
        step=jnp.zeros((), jnp.int32))
    new, loss, _ = step(
        jax_place_state(state, mesh), jax_shard_stacked(graphs, mesh),
        jax_shard_stacked(jnp.asarray(inp["labels"], jnp.int32), mesh),
        jax_shard_stacked(jnp.asarray(inp["weights"]), mesh))
    return (float(loss), port_worlds.flat(new.params),
            port_worlds.flat(new.batch_stats))


@pytest.mark.parametrize("name", ["heat2", "heat2_uneven"])
def test_dp_gradients_match_single_device(world, name):
    """The DP step over 4 ranks equals the JAX package's DP step on the
    same 4 buckets (itself equal to one device, tests/test_parallel.py):
    the global batch's weighted-mean loss, and the parameters after one
    Adam step. 'heat2_uneven' gives the ranks weight sums 2, 1, 0 and 2,
    so the loss's denominator must be the global one."""
    inputs, results = world
    loss_j, params_j, _ = jax_dp(inputs[f"dp/{name}"])
    for rank in range(WORLD):
        loss, params, _ = results[rank][f"dp/{name}"]
        assert abs(loss - loss_j) < 1e-5
        for k in params_j:
            np.testing.assert_allclose(params[k], params_j[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dp_lattice_gradients_match_single_device(world):
    """The DP step on the lattice form (HEAT4's twin) equals the JAX
    package's DP lattice step."""
    inputs, results = world
    loss_j, params_j, _ = jax_dp(inputs["dp/lattice"])
    for rank in range(WORLD):
        loss, params, _ = results[rank]["dp/lattice"]
        assert abs(loss - loss_j) < 1e-5
        for k in params_j:
            np.testing.assert_allclose(params[k], params_j[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dp_step_with_batch_norm_model(world):
    """GIN's BatchNorm under data parallelism: each rank normalises by its
    own bucket and the running statistics are averaged over the ranks
    (not rank 0's), as the JAX package's step averages them; they moved,
    and every rank holds the same."""
    inputs, results = world
    inp = inputs["dp/gin_bn"]
    loss_j, params_j, stats_j = jax_dp(inp)
    start = port_worlds.flat(inp["variables"]["batch_stats"])
    for rank in range(WORLD):
        loss, params, stats = results[rank]["dp/gin_bn"]
        assert abs(loss - loss_j) < 1e-5
        for k in params_j:
            np.testing.assert_allclose(params[k], params_j[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert sorted(stats) == sorted(stats_j)
        for k in stats_j:
            np.testing.assert_allclose(stats[k], stats_j[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(stats[k],
                                          results[0]["dp/gin_bn"][2][k])
    assert max(float(np.abs(stats_j[k] - start[k]).max()) for k in start) > 0


class TinyCNN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.fc = torch.nn.Linear(8, 16)

    def forward(self, x):
        x = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(x.mean(dim=(2, 3)))


def test_dp_featurizer_matches_single_device():
    """make_dp_featurizer over 4 devices (the CPU four times): the batch
    split in 4, the features joined in order equal the unsplit forward
    and the JAX package's make_dp_featurizer over its 4-device mesh on
    the same weights, to rtol 1e-5 / atol 1e-6."""
    torch.manual_seed(0)
    model = TinyCNN().eval()
    rng = np.random.RandomState(0)
    patches = torch.from_numpy(rng.rand(8, 16, 16, 3).astype(np.float32))
    variables = dict(model.named_parameters())
    with torch.no_grad():
        ref = model(patches)
        fn = make_dp_featurizer(
            lambda v, p: torch.func.functional_call(model, v, (p,)),
            [CPU] * WORLD)
        out = fn(variables, patches)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)

    def jax_apply(v, p):    # TinyCNN in jax.numpy, NHWC
        x = jax.lax.conv_general_dilated(
            p, v["conv.weight"], (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)
        x = jax.nn.relu(x + v["conv.bias"]).mean(axis=(1, 2))
        return x @ v["fc.weight"] + v["fc.bias"]

    jv = {k: jnp.asarray(t.detach().numpy()) for k, t in variables.items()}
    jv["conv.weight"] = jv["conv.weight"].transpose(2, 3, 1, 0)
    jv["fc.weight"] = jv["fc.weight"].T
    out_j = jax_make_dp_featurizer(jax_apply, jax_make_mesh(WORLD))(
        jv, jnp.asarray(patches.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        fn(variables, patches[:7])


def test_sharded_encoder_matches_single_device(tmp_path):
    """The constructor's two-CNN encoder ('kimia' features + HoVer-Net
    typing over one patch stream) sharded over 4 devices equals the JAX
    package's encoder sharded over its 4-device mesh, and the port's
    unsharded encoder, from the same reference-layout weight files:
    features rtol 1e-4 / atol 1e-5 and types equal, through the
    pad-and-slice path (10 patches over 4 devices).

    The JAX encoder is assembled as its make_cnn_encoder assembles it
    with a mesh (`_make_encode` pads to the mesh and slices back,
    `make_sharded_batch_apply` shard_maps the two CNNs), with the weights
    as arguments of one jit (closing over them takes XLA minutes to
    compile, tests/test_torch_construct.py)."""
    from wsi_hgnn_tpu.models.featurizers.densenet import (
        KimiaNet as JaxKimiaNet)
    from wsi_hgnn_tpu.models.featurizers.hovernet import (
        HoVerNet as JaxHoVerNet, hovernet_typing_apply)
    from wsi_hgnn_tpu_torch.models.featurizers import KimiaNet, _seeded
    from wsi_hgnn_tpu_torch.models.featurizers import convert as fconvert
    from test_torch_construct import _perturbed, hovernet_variables

    kpath, hpath = tmp_path / "KimiaNet.pth", tmp_path / "hovernet.tar"
    kimia = _perturbed(_seeded(KimiaNet(), 5), 5)
    torch.save({k: torch.from_numpy(v) for k, v in
                fconvert.kimianet_state_dict(kimia).items()}, kpath)
    torch.save({"desc": {k: torch.from_numpy(v) for k, v in
                         fconvert.hovernet_state_dict(
                             hovernet_variables(6)).items()}}, hpath)
    hcfg = {"hovernet_model_path": str(hpath), "mode": "fast"}
    kcfg = {"kimianet_model_path": str(kpath)}
    cfg = {"feature_dim": 1024, "n_node_type": 6}
    rng = np.random.RandomState(3)
    patches = rng.rand(10, 96, 96, 3).astype(np.float32)
    enc_1 = make_cnn_encoder("kimia", cfg, hcfg, kcfg, with_typing=True,
                             device="cpu")
    f1, t1 = enc_1(patches)
    enc_4 = make_cnn_encoder("kimia", cfg, hcfg, kcfg, with_typing=True,
                             devices=[CPU] * WORLD)
    assert enc_4.devices == (CPU,) * WORLD
    f4, t4 = enc_4(patches)

    jkimia = jconvert.load_kimianet(str(kpath))
    jhover = jconvert.hovernet_torch_to_flax(
        jconvert.load_torch_state_dict(str(hpath)), 6)
    kimianet = JaxKimiaNet()
    hovernet = JaxHoVerNet(nr_types=6, mode="fast", with_fc1=False)
    mesh = jax_make_mesh(WORLD)

    @jax.jit
    def sharded(kv, hv, imgs):
        def both(x):
            x = jfeat._norm_pixels(x)
            return (kimianet.apply(kv, x, train=False)[0],
                    hovernet_typing_apply(hovernet, hv, x))
        return jax_make_sharded_batch_apply(both, mesh)(imgs)

    f_j, t_j = jfeat._make_encode(
        lambda a: sharded(jkimia, jhover, a), WORLD, None)(patches)
    assert f1.shape == (10, 1024) and t1.shape == (10,)
    np.testing.assert_allclose(f4, f_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t4, t_j)
    np.testing.assert_allclose(f4, f1, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t4, t1)


def test_encoder_mesh_config_gate(monkeypatch):
    """dp_devices: 'all' (the default) -> every card, an int -> that many,
    1/0/null -> None (one card); the CPU never shards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cuda = torch.device("cuda")
    devs = construct.encoder_mesh({}, cuda)
    assert devs == tuple(torch.device("cuda", i) for i in range(8))
    assert construct.encoder_mesh({"dp_devices": "all"}, cuda) == devs
    for one in (1, 0, None, "1"):
        assert construct.encoder_mesh({"dp_devices": one}, cuda) is None
    assert construct.encoder_mesh({"dp_devices": 4}, cuda) == devs[:4]
    assert construct.encoder_mesh({"dp_devices": 16}, cuda) == devs
    assert construct.encoder_mesh({}, CPU) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert construct.encoder_mesh({}, cuda) is None


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_featurizer_has_no_collectives(n_dev):
    """make_sharded_batch_apply (the constructor's DataParallel axis)
    issues no collective, and each device runs the same per-device batch
    (4 patches), so the work per device is constant over 1-8 devices."""
    torch.manual_seed(1)
    model = TinyCNN().eval()
    per_dev, seen = 4, []

    def build(dev):
        def run(p):
            seen.append(p.shape[0])
            return model(p)
        return run

    rng = np.random.RandomState(2)
    patches = torch.from_numpy(
        rng.rand(per_dev * n_dev, 32, 32, 3).astype(np.float32))
    collectives.reset_counts()
    with torch.no_grad():
        out = make_sharded_batch_apply(build, [CPU] * n_dev)(patches)
    assert out.shape == (per_dev * n_dev, 16) and torch.isfinite(out).all()
    assert seen == [per_dev] * n_dev
    assert collectives.counts() == {"all_reduce": 0, "broadcast": 0}


def test_stack_graphs_stacks_host_arrays():
    """stack_graphs: equal-capacity host graphs on a leading axis (numpy,
    the metadata of the first), as the DP tests' stacked batches."""
    from wsi_hgnn_tpu_torch.graph.typed_graph import from_arrays, unstack

    rng = np.random.RandomState(0)
    gs = [from_arrays(rng.randn(5, 4).astype(np.float32),
                      rng.randint(0, 5, 7), rng.randint(0, 5, 7),
                      node_capacity=8, edge_capacity=12) for _ in range(3)]
    st = stack_graphs(gs)
    assert isinstance(st.feat, np.ndarray) and st.feat.shape == (3, 8, 4)
    assert st.src.shape == (3, 12)
    for g, back in zip(gs, unstack(st)):
        np.testing.assert_array_equal(back.src, g.src)
        np.testing.assert_array_equal(back.feat, g.feat)
