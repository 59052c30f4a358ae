"""Port parity of the checkpoint contract (wsi_hgnn_tpu_torch/train/
flax_msgpack.py, train/checkpoint.py) and of the trainer, evaluator and
predictor around it, against the JAX package on the CPU: flax msgpack
both ways, optax state layouts, and checkpoints written by one package
and read, resumed or served by the other."""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from wsi_hgnn_tpu.config import parse_optimizer as jax_parse_optimizer
from wsi_hgnn_tpu.models import lattice as jlat
from wsi_hgnn_tpu.serve import SlidePredictor as JaxPredictor
from wsi_hgnn_tpu.train.evaluator import HomoGraphEvaluator as JaxEvaluator
from wsi_hgnn_tpu.train.trainer import GNNTrainer as JaxTrainer
from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.config import parse_optimizer
from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz
from wsi_hgnn_tpu_torch.models import lattice as tlat
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.train import (GNNTrainer, HomoGraphEvaluator,
                                      lattice_train_step)
from wsi_hgnn_tpu_torch.train import checkpoint as tckpt
from wsi_hgnn_tpu_torch.train import flax_msgpack
import port_threads  # noqa: F401  (torch threads per test worker)

D, RADIUS = 16, 4  # k = 3
GNN = {"name": "HEAT4", "n_node_types": 6, "num_layers": 2, "in_dim": D,
       "hidden_dim": 16, "out_dim": 2, "n_heads": 2, "feat_drop": 0.2,
       "graph_pooling_type": "mean"}


def _same(a, b, path="tree"):
    """Equal trees: dict keys in order, array dtypes, shapes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b), (path, type(a), type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@functools.lru_cache(maxsize=None)
def _jax_model_and_params(seed=0):
    rng = np.random.RandomState(seed)
    g = jlat.build_lattice_device(
        jnp.asarray(rng.randn(1, 24, D).astype(np.float32)),
        jnp.asarray(rng.randint(0, 6, (1, 24)).astype(np.int32)),
        jnp.ones((1, 24), bool), RADIUS, 6)
    kw = dict(in_dim=D, hidden_dim=16, out_dim=2, n_layers=2, n_heads=2,
              n_node_types=6, dropout=0.0)
    model = jlat.HEATNet4Lattice(**kw)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), g)["params"]
    return model, params, g, kw


def test_msgpack_reads_a_jax_trainer_state():
    """A JAX trainer's checkpoint tree (params, Adam chain state after two
    updates, PRNG key) written by flax reads back equal in the port."""
    _, params, _, _ = _jax_model_and_params()
    tx = jax_parse_optimizer({"opt_method": "ADAM", "lr": 1e-3,
                              "weight_decay": 5e-3})
    opt_state = tx.init(params)
    grads = jax.tree.map(jnp.ones_like, params)
    update = jax.jit(tx.update)
    for _ in range(2):
        _, opt_state = update(grads, opt_state, params)
    state = {"params": params, "batch_stats": {}, "opt_state": opt_state,
             "rng": jax.random.PRNGKey(3)}
    data = serialization.to_bytes(state)
    got = flax_msgpack.restore(data)
    _same(serialization.msgpack_restore(data), got)
    assert list(got["opt_state"]) == ["0", "1", "2"]
    assert int(got["opt_state"]["1"]["count"]) == 2


def test_msgpack_written_by_the_port_matches_flax():
    """The port's bytes equal flax's msgpack_serialize for the same tree
    (every length form of str, map and ext), and flax reads them back."""
    rng = np.random.RandomState(0)
    tree = {
        "f32": rng.randn(3, 4).astype(np.float32),
        "i32": np.arange(7, dtype=np.int32),
        "u8": rng.randint(0, 255, 300).astype(np.uint8),
        "bool": np.array([True, False]),
        "f64_0d": np.array(2.5),
        "i64": np.array([-(2 ** 40), 2 ** 40], np.int64),
        "one_byte": np.zeros(1, np.uint8),
        "big": np.zeros(70000, np.uint8),
        "scalars": {"f": np.float32(1.5), "i": np.int32(-3)},
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
             -128, -129, -32768, -32769, -(2 ** 31) - 1, 2 ** 63])},
        "float": 0.1, "yes": True, "no": False, "none": None,
        "s" * 40: "t" * 300, "empty": {}, "bytes": b"\x00\x01",
    }
    data = flax_msgpack.to_bytes(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = serialization.msgpack_restore(data)
    _same(back, flax_msgpack.restore(data))
    assert sorted(back) == sorted(tree)
    for key in ("f32", "u8", "big", "scalars", "ints"):
        _same({k: back[key][k] for k in sorted(tree[key])}
              if isinstance(tree[key], dict) else back[key],
              {k: tree[key][k] for k in sorted(tree[key])}
              if isinstance(tree[key], dict) else tree[key])


def test_msgpack_chunked_arrays(monkeypatch):
    """flax splits an array over its chunk size into a chunk map; the port
    joins it on read, and refuses to write one."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(3 * 50, dtype=np.float32).reshape(3, 50)
    data = serialization.msgpack_serialize({"a": {"w": arr}, "b": np.ones(2)})
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.restore(data)
    np.testing.assert_array_equal(got["a"]["w"], arr)
    assert got["a"]["w"].dtype == np.float32
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.to_bytes({"w": arr})


@pytest.mark.parametrize("method,lr,wd", [("ADAM", 1e-3, 5e-3),
                                          ("ADAM", 1e-3, 0.0),
                                          ("adagrad", 1e-2, 5e-3),
                                          ("adadelta", 1.0, 5e-3),
                                          ("SGD", 0.1, 5e-3)])
def test_opt_state_matches_the_optax_chain(method, lr, wd):
    """After two steps from the same params and gradients, the port's
    optimizer state written in flax layout has the optax chain state's
    tree, dtypes and values; read back into a fresh torch optimizer, it
    takes the same next step."""
    model, params, _, kw = _jax_model_and_params(1)
    config_optim = {"opt_method": method, "lr": lr, "weight_decay": wd}
    tx = jax_parse_optimizer(config_optim)
    opt_state = tx.init(params)
    tm = convert.load_flax_variables(tlat.HEATNet4Lattice(**kw),
                                     {"params": jax.tree.map(np.asarray,
                                                             params)})
    opt = parse_optimizer(config_optim, tm.parameters())
    rng = np.random.RandomState(2)
    flat, treedef = jax.tree.flatten(params)

    @jax.jit
    def step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return opt_state, jax.tree.map(lambda p, u: p + u, params, updates)
    for _ in range(2):
        grads = jax.tree.unflatten(treedef, [
            jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32) * 1e-2)
            for x in flat])
        opt_state, params = step(grads, opt_state, params)
        tgrads = convert.params_from_flax(tm, jax.tree.map(np.asarray, grads))
        for name, p in tm.named_parameters():
            p.grad = torch.from_numpy(tgrads[name])
        opt.step()
    want = serialization.to_state_dict(jax.tree.map(np.asarray, opt_state))
    got = tckpt.opt_state_to_flax(opt, tm, config_optim)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9,
                                   err_msg=jax.tree_util.keystr(path))

    fresh = convert.load_flax_variables(tlat.HEATNet4Lattice(**kw), {
        "params": jax.tree.map(np.asarray, params)})
    opt2 = parse_optimizer(config_optim, fresh.parameters())
    tckpt.load_opt_state_from_flax(opt2, fresh, want, config_optim)
    for model_, opt_ in ((tm, opt), (fresh, opt2)):
        for p in model_.parameters():
            p.grad = torch.full_like(p, 1e-2)
        opt_.step()
    for (name, a), b in zip(tm.named_parameters(), fresh.parameters()):
        # params of size ~1 carry a one-ulp (1.2e-7) difference
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6, msg=name)


# --------------------------------------------------------------------- #
# checkpoints across packages
# --------------------------------------------------------------------- #
def _cohort(root: Path, n_slides=8, seed=0):
    """KNN-lattice slides (radius 4) with TCGA barcodes; even slides are
    normal (label 0) and carry a feature shift."""
    rng = np.random.RandomState(seed)
    paths, normals = [], []
    for i in range(n_slides):
        n = rng.randint(20, 40)
        feat = rng.randn(n, D).astype(np.float32) + (i % 2) * 1.5
        types = rng.randint(0, 6, n).astype(np.int32)
        g = tlat.build_lattice_device(torch.from_numpy(feat[None]),
                                      torch.from_numpy(types[None]),
                                      torch.ones(1, n, dtype=torch.bool),
                                      RADIUS, 6)
        k = g.idx.shape[2]
        barcode = f"TCGA-{i:02d}-0000-01Z-00-DX1"
        p = str(root / f"{barcode}.npz")
        save_graph_npz(p, feat, np.repeat(np.arange(n), k),
                       g.idx[0].reshape(-1).numpy(), node_type=types,
                       esign=g.esign[0].reshape(-1).numpy(),
                       sim=g.sim[0].reshape(-1).numpy())
        paths.append(p)
        if i % 2 == 0:
            normals.append(barcode[:16])
    (root / "train.txt").write_text("\n".join(paths[:6]) + "\n")
    (root / "test.txt").write_text("\n".join(paths[5:]) + "\n")
    (root / "normal.txt").write_text("\n".join(normals) + "\n")
    return paths


def _config(root: Path, ckpt: str, epochs: int, **gnn):
    return {"name": "T", "train_type": "gnn", "eval_type": "homo-graph",
            "datasets": {"dataset": "BRCA", "task": "cancer classification",
                         "train_path": str(root / "train.txt"),
                         "eval_path": str(root / "test.txt"),
                         "valid_path": str(root / "test.txt"),
                         "normal_path": str(root / "normal.txt")},
            "checkpoint": {"path": str(root / ckpt)},
            "optimizer": {"opt_method": "ADAM", "lr": 0.001,
                          "weight_decay": 0.005},
            "GNN": dict(GNN, **gnn),
            "train": {"num_epochs": epochs, "batch_size": 2, "loss": "CE"}}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    return root, _cohort(root)


def test_port_checkpoint_contract_resume_and_jax_evaluator(cohort):
    """Two port epochs write the checkpoint contract; JAX's evaluator reads
    the port's checkpoint and reports the port evaluator's metrics; a
    second trainer resumes at epoch 2."""
    root, _ = cohort
    cfg = _config(root, "ckpt_port", 2)
    stats = GNNTrainer(cfg, seed=0, device="cpu").train()
    ckpt = Path(cfg["checkpoint"]["path"])
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "configs.json", "model_v2.msgpack", "training_stats.json",
        "version.txt"]
    assert (ckpt / "version.txt").read_text() == "2\n"
    lines = (ckpt / "training_stats.json").read_text().splitlines()
    assert [json.loads(l)["Epoch"] for l in lines] == [1, 2]
    assert json.loads((ckpt / "configs.json").read_text()) == cfg

    port = HomoGraphEvaluator(cfg, verbose=False, device="cpu").eval()
    want = JaxEvaluator(cfg, verbose=False).eval()
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        port, [stats[f"Testing {m}"] for m in
               ("Accuracy", "F1", "Precision", "Recall", "AUC")],
        rtol=0, atol=1e-5)

    resumed = GNNTrainer(dict(cfg, train=dict(cfg["train"], num_epochs=3)),
                         seed=0, device="cpu")
    assert resumed.start_epoch == 2
    for (name, a), b in zip(
            resumed.model.named_parameters(),
            convert.params_from_flax(resumed.model, flax_msgpack.restore(
                (ckpt / "model_v2.msgpack").read_bytes())["params"]).values()):
        np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=name)
    assert resumed.train()["Epoch"] == 3
    assert (ckpt / "version.txt").read_text() == "3\n"
    assert not (ckpt / "model_v2.msgpack").exists()


@pytest.fixture(scope="module")
def jax_checkpoint(cohort):
    """One JAX trainer epoch (Adam, dropout 0) on the cohort."""
    root, _ = cohort
    cfg = _config(root, "ckpt_jax", 1, feat_drop=0.0)
    trainer = JaxTrainer(cfg, seed=0)
    trainer.train()
    return cfg, trainer


def test_port_resumes_a_jax_checkpoint_and_takes_its_next_step(
        jax_checkpoint):
    """The port resumes the JAX-written Adam checkpoint (params and
    moments) and, with augmentation off, takes the JAX trainer's next
    step on the same batch."""
    cfg, jtr = jax_checkpoint
    port = GNNTrainer(dict(cfg, train=dict(cfg["train"], num_epochs=2)),
                      seed=0, device="cpu")
    assert port.start_epoch == 1
    g_t, labels, weights = next(iter(port.loader))
    g_j = jlat.LatticeGraph(*(
        jnp.asarray(a.numpy().astype(np.int32) if a.dtype == torch.int64
                    else a.numpy()) for a in g_t))
    state = jtr.state

    @jax.jit
    def jax_step(params, opt_state):
        def loss_fn(p):
            logits = jtr._lat_model.apply({"params": p}, g_j, train=True)
            return jtr.loss_fcn(logits, jnp.asarray(labels),
                                jnp.asarray(weights))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = jtr.tx.update(grads, opt_state, params)
        return loss, jax.tree.map(lambda p, u: p + u, params, updates)
    jloss, want = jax_step(state.params, state.opt_state)
    want = jax.tree.map(np.asarray, want)

    b, n, k = g_t.idx.shape
    ones = tlat.TrainMasks(torch.ones(b, n, dtype=torch.bool),
                           torch.ones(b, n, k, dtype=torch.bool),
                           torch.ones(D, dtype=torch.bool))
    loss, _ = lattice_train_step(
        port.model, port.optimizer, port.loss_fcn, g_t,
        torch.from_numpy(labels).long(), torch.from_numpy(weights),
        masks=ones)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = convert.params_from_flax(port.model, want)
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), got[name], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_slide_predictor_serves_a_jax_checkpoint(jax_checkpoint, cohort):
    """SlidePredictor(checkpoint_path=) on the JAX-written checkpoint
    answers as JAX's SlidePredictor does, for slides it builds itself."""
    cfg, _ = jax_checkpoint
    path = cfg["checkpoint"]["path"]
    rng = np.random.RandomState(5)
    slides = [(rng.randn(n, D).astype(np.float32),
               rng.randint(0, 6, n).astype(np.int32)) for n in (30, 45)]
    want = JaxPredictor(cfg, radius=RADIUS, checkpoint_path=path
                        ).predict_many(slides)
    got = SlidePredictor(cfg, radius=RADIUS, checkpoint_path=path,
                         device="cpu").predict_many(slides)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # with neither argument the config's checkpoint.path is served
    got2 = SlidePredictor(cfg, radius=RADIUS, device="cpu").predict_many(
        slides)
    np.testing.assert_array_equal(got2, got)


def test_main_trains_then_evaluates_on_the_cpu(cohort):
    """`python -m wsi_hgnn_tpu_torch.main -config <yml> -device cpu` in
    train and then eval mode, on a YAML file the port's reader parses."""
    from wsi_hgnn_tpu_torch import main

    root, _ = cohort
    yml = root / "main.yml"
    yml.write_text(f"""name: T  # a comment
train_type: gnn
eval_type: homo-graph
datasets:
  dataset: "BRCA"
  task: "cancer classification"
  train_path: "{root / 'train.txt'}"
  eval_path: "{root / 'test.txt'}"
  valid_path: "{root / 'test.txt'}"
  normal_path: "{root / 'normal.txt'}"
checkpoint:
  path: "{root / 'ckpt_main'}"
optimizer:
  opt_method: "ADAM"
  lr: 0.001
  weight_decay: 0.005
GNN:
  name: "HEAT2"
  n_node_types: 6
  num_layers: 2
  in_dim: {D}
  hidden_dim: 16
  out_dim: 2
  n_heads: 2
  feat_drop: 0.2
  graph_pooling_type: "mean"
train:
  num_epochs: 1
  batch_size: 2
  loss: "CE"
""")
    stats = main.main(["-config", str(yml), "-seed", "3", "-device", "cpu"])
    got = main.main(["-config", str(yml), "-mode", "eval", "-device", "cpu"])
    np.testing.assert_allclose(
        got, [stats[f"Testing {m}"] for m in
              ("Accuracy", "F1", "Precision", "Recall", "AUC")], atol=1e-5)
    assert (root / "ckpt_main" / "version.txt").read_text() == "1\n"
