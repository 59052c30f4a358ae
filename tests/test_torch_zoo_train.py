"""Port parity of the TypedGraph training, evaluation and serving paths
(wsi_hgnn_tpu_torch/train/{trainer,evaluator,checkpoint}.py, serve.py,
data/loader.py, graph/build.py) against the JAX package on the CPU:
lockstep trajectories with JAX's augmentation and dropout masks fed in,
GIN checkpoints (batch_stats included) resumed across packages, the
per-slide evaluator and the typed predictor."""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from wsi_hgnn_tpu import models as jmodels
from wsi_hgnn_tpu.config import parse_loss as jax_parse_loss
from wsi_hgnn_tpu.config import parse_optimizer as jax_parse_optimizer
from wsi_hgnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from wsi_hgnn_tpu.graph import to_homogeneous as jax_to_homogeneous
from wsi_hgnn_tpu.serve import SlidePredictor as JaxPredictor
from wsi_hgnn_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from wsi_hgnn_tpu.config import parse_gnn_model as jax_parse_gnn_model
from wsi_hgnn_tpu.train.evaluator import evaluate as jax_evaluate
from wsi_hgnn_tpu.train.trainer import GNNTrainer as JaxTrainer
from wsi_hgnn_tpu.train.trainer import select_dataset as jax_select_dataset
from wsi_hgnn_tpu.train.trainer import TrainState
from wsi_hgnn_tpu_torch import convert, models
from wsi_hgnn_tpu_torch.config import parse_loss, parse_optimizer
from wsi_hgnn_tpu_torch.data.datasets import save_graph_npz
from wsi_hgnn_tpu_torch.data.loader import GraphLoader
from wsi_hgnn_tpu_torch.graph import batch_graphs, transforms
from wsi_hgnn_tpu_torch.models.lattice import build_lattice_device
from wsi_hgnn_tpu_torch.serve import SlidePredictor
from wsi_hgnn_tpu_torch.train import (GNNTrainer, HomoGraphEvaluator,
                                      typed_train_step)
from wsi_hgnn_tpu_torch.train.trainer import select_dataset

from test_torch_zoo import ZOO, flat, graph_pair

D, T, RADIUS, CPU = 8, 3, 4, torch.device("cpu")


# --------------------------------------------------------------------- #
# lockstep trajectories
# --------------------------------------------------------------------- #
def _dropout_with(take):
    """A flax method interceptor that runs every active nn.Dropout with the
    keep-mask take(shape, rate) returns instead of its PRNG draw."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic")
        det = mod.deterministic if det is None else det
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = take(x.shape, mod.rate)
        return jnp.where(keep, x / (1.0 - mod.rate), 0.0)
    return fnn.intercept_methods(interceptor)


def _jax_step_with_masks(host):
    """(shapes(state, g, labels, weights) -> [(shape, rate)] of the step's
    dropout calls, step(state, g, labels, weights, masks)): the JAX
    trainer's _train_step_impl, jitted, its dropout fed `masks`."""
    def shapes(*args):
        out = []

        def take(shape, rate):
            out.append((shape, rate))
            return jnp.ones(shape, bool)
        with _dropout_with(take):
            jax.eval_shape(
                lambda *a: JaxTrainer._train_step_impl(host, *a), *args)
        return out

    @jax.jit
    def step(state, g, labels, weights, masks):
        it = iter(masks)
        with _dropout_with(lambda shape, rate: next(it)):
            return JaxTrainer._train_step_impl(host, state, g, labels,
                                               weights)
    return shapes, step


def _gat_pair():
    """GAT with the residual on (parse_gnn_model turns it off): layer 1's
    residual is the identity, the last layer's a res_fc product, both on
    the feature-dropped input."""
    kw = dict(n_layers=2, in_dim=D, hidden_dim=16, out_dim=3, heads=(2, 2, 1),
              feat_drop=0.3, attn_drop=0.3, residual=True,
              graph_pooling_type="mean")
    return jmodels.GAT(**kw), models.GAT(**kw), False


def _zoo_pair(case, **changes):
    from wsi_hgnn_tpu_torch.config import parse_gnn_model

    section = dict(ZOO[case], **changes)
    jm, hetero = jax_parse_gnn_model(section)
    return jm, parse_gnn_model(section)[0], hetero


LOCKSTEP = {"gat": _gat_pair,
            "gin": lambda: _zoo_pair("gin_att_mean", feat_drop=0.4),
            "hgt": lambda: _zoo_pair("hgt")}
DEAD = {"gat": "gat_2", "gin": None, "hgt": "gcs_1"}


@pytest.mark.parametrize("case", sorted(LOCKSTEP))
def test_lockstep_adam_with_weight_decay_matches_jax(case):
    """Five Adam steps (lr 1e-3, weight decay 5e-3) of the JAX trainer's
    _train_step_impl and the port's typed_train_step from the same
    weights, over two alternating batches (one with a zero-weight slide),
    JAX's augmentation masks and the same dropout masks fed to both: the
    losses agree to 5e-5, the parameters (running statistics included)
    to 1e-4. The dead last layers move by their weight decay alone, as
    optax decays them."""
    jm, tm, hetero = LOCKSTEP[case]()
    rng = np.random.RandomState(0)
    batches = []
    for seed, labels, weights in ((0, [0, 2], [1.0, 1.0]),
                                  (1, [1, 0], [1.0, 0.0])):
        g_j, g_t = graph_pair(hetero, seed)
        batches.append((g_j, g_t, np.array(labels, np.int32),
                        np.array(weights, np.float32)))
    convert.init_flax_like_(tm, seed=1)
    variables = convert.to_flax_variables(tm)
    # nonzero biases: a weight-decayed parameter whose gradient is f32
    # noise (a bias ahead of a BatchNorm) steps +-lr on its sign under Adam
    for k, v in flat(variables["params"]).items():
        v += rng.standard_normal(v.shape).astype(np.float32) * 0.05
    convert.load_flax_variables(tm, variables)
    config_optim = {"opt_method": "ADAM", "lr": 1e-3, "weight_decay": 5e-3}
    tx = jax_parse_optimizer(config_optim)
    jloss = jax_parse_loss({"loss": "CE"})
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params,
                       batch_stats=jax.tree.map(
                           jnp.asarray, variables.get("batch_stats", {})),
                       opt_state=tx.init(params), rng=jax.random.PRNGKey(3),
                       step=jnp.zeros((), jnp.int32))
    host = types.SimpleNamespace(
        model=jm, tx=tx, loss_fcn=jloss,
        _prepare_graph=lambda g: g if hetero else jax_to_homogeneous(g))
    shapes, jax_step = _jax_step_with_masks(host)
    opt = parse_optimizer(config_optim, tm.parameters())
    tloss = parse_loss({"loss": "CE"})
    j_losses, t_losses = [], []
    for step in range(5):
        g_j, g_t, labels, weights = batches[step % 2]
        aug_key = jax.random.split(state.rng, 3)[1]
        k1, k2, k3 = jax.random.split(aug_key, 3)
        masks = transforms.TrainMasks(*(
            torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, s)))
            for k, s in ((k1, (g_j.num_nodes,)), (k2, (g_j.num_edges,)),
                         (k3, (D,)))))
        args = (state, g_j, jnp.asarray(labels), jnp.asarray(weights))
        if step == 0:   # both batches have one shape: one trace suffices
            calls = shapes(*args)
        used = [rng.rand(*shape) >= rate for shape, rate in calls]
        state, loss, _ = jax_step(*args, used)
        j_losses.append(float(loss))
        loss_t, prob = typed_train_step(
            tm, opt, tloss, g_t, torch.from_numpy(labels).long(),
            torch.from_numpy(weights), hetero, masks=masks,
            drops=models.DropSource(
                masks=[torch.from_numpy(m) for m in used]))
        t_losses.append(float(loss_t))
        assert prob.shape == (2, 3) and len(used) > 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=5e-5)
    assert np.ptp(j_losses) > 1e-3
    want = flat(jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats}))
    got = flat(convert.to_flax_variables(tm))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    if DEAD[case]:
        start = flat(variables["params"])
        for k in want:
            if k.startswith(f"params/{DEAD[case]}/"):
                moved = got[k] - start[k[len("params/"):]]
                assert np.abs(moved).max() > 1e-4, k    # decayed
                # Adam on g = wd * p moves each entry against its sign
                assert (np.sign(moved) != np.sign(start[k[7:]]))[
                    np.abs(start[k[7:]]) > 1e-3].all(), k


# --------------------------------------------------------------------- #
# a cohort on disk: trainer, checkpoints, evaluator, predictor
# --------------------------------------------------------------------- #
def _cohort(root: Path, n_slides=8, seed=0):
    """KNN slides (radius 4) under TCGA barcodes, written twice: typed
    (`het/`) and untyped with self-loops at load (`homo/`). Odd slides
    are tumour (features shifted); slides 3 and 6 use two node types."""
    rng = np.random.RandomState(seed)
    lists = {"het": [], "homo": []}
    normals = []
    for i in range(n_slides):
        n = rng.randint(20, 40)
        feat = rng.randn(n, D).astype(np.float32) + (i % 2) * 1.5
        types = rng.randint(0, 2 if i in (3, 6) else T, n).astype(np.int32)
        g = build_lattice_device(torch.from_numpy(feat[None]),
                                 torch.from_numpy(types[None]),
                                 torch.ones(1, n, dtype=torch.bool), RADIUS, T)
        k = g.idx.shape[2]
        barcode = f"TCGA-{i:02d}-0000-01Z-00-DX1"
        for kind in ("het", "homo"):
            (root / kind).mkdir(exist_ok=True)
            p = str(root / kind / f"{barcode}.npz")
            save_graph_npz(p, feat, np.repeat(np.arange(n), k),
                           g.idx[0].reshape(-1).numpy(), node_type=types,
                           esign=g.esign[0].reshape(-1).numpy(),
                           sim=g.sim[0].reshape(-1).numpy(),
                           n_node_types=T, is_hetero=kind == "het")
            lists[kind].append(p)
        if i % 2 == 0:
            normals.append(barcode[:16])
    for kind, paths in lists.items():
        (root / f"{kind}_train.txt").write_text("\n".join(paths[:5]) + "\n")
        (root / f"{kind}_test.txt").write_text("\n".join(paths[3:]) + "\n")
    (root / "normal.txt").write_text("\n".join(normals) + "\n")


def _config(root: Path, ckpt: str, case: str, epochs=1, hetero=True,
            **train):
    kind = "het" if hetero else "homo"
    return {"name": "T", "train_type": "gnn", "eval_type": "homo-graph",
            "datasets": {"dataset": "BRCA", "task": "cancer classification",
                         "train_path": str(root / f"{kind}_train.txt"),
                         "eval_path": str(root / f"{kind}_test.txt"),
                         "valid_path": str(root / f"{kind}_test.txt"),
                         "normal_path": str(root / "normal.txt")},
            "checkpoint": {"path": str(root / ckpt)},
            "optimizer": {"opt_method": "ADAM", "lr": 0.001,
                          "weight_decay": 0.005},
            "GNN": dict(ZOO[case], out_dim=2),
            "train": dict({"num_epochs": epochs, "batch_size": 2,
                           "loss": "CE"}, **train)}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_cohort")
    _cohort(root)
    return root


def test_loader_batches_equal_jax(cohort):
    """The port's GraphLoader (flat and stacked) packs the batches the
    JAX loader packs, array for array, in the same shuffled order."""
    cfg = _config(cohort, "unused", "hgt")
    data, _ = select_dataset(cfg["datasets"], cfg["datasets"]["train_path"],
                             "train")
    for kw in ({"node_capacity": 128, "edge_capacity": 256},
               {"node_capacity": 48, "edge_capacity": 160, "stacked": True}):
        ours = GraphLoader(data, 2, shuffle=True, seed=5, prefetch=0, **kw)
        theirs = JaxGraphLoader(data, 2, shuffle=True, seed=5, prefetch=0,
                                **kw)
        for idxs_t, idxs_j in zip(ours._index_batches(),
                                  theirs._index_batches()):
            assert idxs_t == idxs_j
            (gt, lt, wt), (gj, lj, wj) = (ours._make_batch(idxs_t),
                                          theirs._make_batch(idxs_j))
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_array_equal(wt, wj)
            for f in ("feat", "node_type", "node_graph", "node_mask", "src",
                      "dst", "esign", "sim", "edge_mask"):
                np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f),
                                              err_msg=f)
            assert gt.edges_sorted and gt.n_graphs == gj.n_graphs


@pytest.fixture(scope="module")
def gin_runs(cohort):
    """A GIN checkpoint from each package: one port epoch on the CPU, and
    two JAX train steps written as version 1."""
    port_cfg = _config(cohort, "gin_port", "gin_att_mean", hetero=False)
    GNNTrainer(port_cfg, seed=0, device="cpu").train()
    jax_cfg = _config(cohort, "gin_jax", "gin_att_mean", hetero=False)
    tr = JaxTrainer(jax_cfg, seed=0)
    for gb, labels, weights in tr.loader:
        if tr.state is None:
            tr.state = tr.init_state(gb)
        tr.state, _, _ = tr._train_step(tr.state, gb, jnp.asarray(labels),
                                        jnp.asarray(weights))
        if int(tr.state.step) == 2:
            break
    tr.checkpoint_manager.write_new_version(jax_cfg, tr._checkpoint_state(),
                                            {"Epoch": 1})
    return port_cfg, jax_cfg


def _ckpt_tree(cfg):
    return flat(jax.tree.map(np.asarray, JaxCheckpoints(
        cfg["checkpoint"]["path"]).load_model_raw()))


@pytest.mark.parametrize("direction", ["jax_resumes_port", "port_resumes_jax"])
def test_gin_checkpoint_resumes_across_packages(gin_runs, direction):
    """A GIN checkpoint (params, batch_stats, Adam moments, rng) written
    by one package is resumed by the other: the restored state equals
    the file, and the resumed trainer writes epoch 2."""
    port_cfg, jax_cfg = gin_runs
    cfg = port_cfg if direction == "jax_resumes_port" else jax_cfg
    cfg = dict(cfg, train=dict(cfg["train"], num_epochs=2))
    written = _ckpt_tree(cfg)
    assert any(k.startswith("batch_stats/gin_0/bn/") for k in written)
    if direction == "jax_resumes_port":
        tr = JaxTrainer(cfg, seed=1)
        gb0, _, _ = tr.loader._make_batch([0, 1])
        tr.state = tr.init_state(gb0)
        assert tr.start_epoch == 1
        got = flat(jax.tree.map(np.asarray, {
            "params": tr.state.params, "batch_stats": tr.state.batch_stats,
            "opt_state": {"1": {"mu": tr.state.opt_state[1].mu}}}))
    else:
        tr = GNNTrainer(cfg, seed=1, device="cpu")
        assert tr.start_epoch == 1 and not tr.lattice
        got = flat(dict(convert.to_flax_variables(tr.model), opt_state={
            "1": {"mu": convert.params_to_flax(tr.model, {
                n: tr.optimizer.state[p]["exp_avg"]
                for n, p in tr.model.named_parameters()})}}))
    for k, v in got.items():
        np.testing.assert_array_equal(v, written[k], err_msg=k)
    assert tr.train()["Epoch"] == 2


_WRITTEN = {}


def _jax_written(cohort, case, hetero):
    """The config of a checkpoint that JAX's CheckpointManager wrote for
    `case` (seeded flax-like weights), written once per module."""
    if case not in _WRITTEN:
        cfg = _config(cohort, f"jax_{case}", case, hetero=hetero)
        from wsi_hgnn_tpu_torch.config import parse_gnn_model

        variables = convert.to_flax_variables(convert.init_flax_like_(
            parse_gnn_model(cfg["GNN"])[0], seed=2))
        JaxCheckpoints(cfg["checkpoint"]["path"]).write_new_version(
            cfg, dict(variables, batch_stats=variables.get("batch_stats", {})),
            {"Epoch": 1})
        _WRITTEN[case] = cfg
    return _WRITTEN[case]


@pytest.mark.parametrize("case,hetero", [("hgt", True), ("gcn_att", False)])
def test_typed_evaluator_matches_jax_per_slide(cohort, case, hetero):
    """HomoGraphEvaluator on the TypedGraph path equals JAX's on a
    JAX-written checkpoint (metrics 1e-5, probabilities 1e-5). For HGT
    the test split mixes slides with two and three node types, so one
    flat batched forward (batch-global occupancy) gives other answers:
    the per-slide loop is what matches."""
    cfg = _jax_written(cohort, case, hetero)
    data, average = jax_select_dataset(cfg["datasets"],
                                       cfg["datasets"]["eval_path"], "eval")
    want = jax_evaluate(jax_parse_gnn_model(cfg["GNN"])[0],
                        JaxCheckpoints(cfg["checkpoint"]["path"]
                                       ).restore_variables(),
                        data, average, hetero)
    ev = HomoGraphEvaluator(cfg, verbose=False, device="cpu")
    got_m = ev.eval()
    np.testing.assert_allclose(
        got_m, [want[k] for k in ("acc", "f1", "precision", "recall", "auc")],
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(ev.last_metrics["prob"], want["prob"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ev.last_metrics["label"], want["label"])
    assert ev.splits.loader_of(ev.test_data)[0] == "typed"
    if not hetero:
        return
    data = ev.test_data
    flat_batch = batch_graphs([data[i][0] for i in range(len(data))]
                              ).to_torch(CPU)
    with torch.no_grad():
        batched = torch.softmax(ev.model(flat_batch), -1).numpy()
    assert np.abs(batched - ev.last_metrics["prob"]).max() > 1e-3


@pytest.mark.parametrize("case,hetero", [("hgt", True), ("gcn_att", False)])
def test_typed_predictor_matches_jax_and_ignores_grouping(cohort, case,
                                                          hetero):
    """SlidePredictor's TypedGraph path (graph built per slide, self-loops
    and the untyped view for GCN) answers as JAX's predictor (1e-4), and
    a slide's answer does not depend on its group."""
    cfg = _jax_written(cohort, case, hetero)
    rng = np.random.RandomState(5)
    slides = [(rng.randn(n, D).astype(np.float32),
               rng.randint(0, 2 if n == 30 else T, n).astype(np.int32))
              for n in (30, 45, 3)]
    want = JaxPredictor(cfg, radius=RADIUS, n_node_types=T).predict_many(
        slides)
    pred = SlidePredictor(cfg, radius=RADIUS, n_node_types=T, device="cpu")
    assert not pred.uses_lattice(3, 64)
    got = pred.predict_many(slides)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for i, s in enumerate(slides):
        np.testing.assert_allclose(pred.predict(*s), got[i], rtol=1e-5,
                                   atol=1e-6)


def test_heat4_with_the_lattice_off_trains_on_the_typed_path(cohort):
    """`train.lattice: off` puts HEAT4 on the TypedGraph step (as the JAX
    trainer chooses); its checkpoint serves on the lattice path too."""
    cfg = _config(cohort, "heat4_off", "heat4", lattice="off")
    tr = GNNTrainer(cfg, seed=0, device="cpu")
    assert not tr.lattice and not JaxTrainer(cfg, seed=0)._lattice
    assert isinstance(tr.model, models.HEATNet4)
    stats = tr.train()
    assert np.isfinite(stats["Train Loss: "])
    on = dict(cfg, train=dict(cfg["train"], lattice="auto"))
    assert GNNTrainer(dict(on, checkpoint={"path": str(cohort / "x")}),
                      seed=0, device="cpu").lattice
    rng = np.random.RandomState(1)
    slide = (rng.randn(50, D).astype(np.float32),
             rng.randint(0, T, 50).astype(np.int32))
    lat = SlidePredictor(cfg, radius=RADIUS, n_node_types=T, device="cpu")
    typed = SlidePredictor(cfg, radius=RADIUS, n_node_types=T, device="cpu",
                           use_lattice=False)
    assert lat.uses_lattice(1, 64) and not typed.uses_lattice(1, 64)
    np.testing.assert_allclose(lat.predict(*slide), typed.predict(*slide),
                               rtol=1e-5, atol=1e-5)


def test_main_trains_and_evaluates_a_zoo_config_on_the_cpu(cohort):
    """`python -m wsi_hgnn_tpu_torch.main -config <yml> -mode train|eval
    -device cpu` on a GAT config file."""
    from wsi_hgnn_tpu_torch import main

    cfg = _config(cohort, "ckpt_main", "gat", hetero=False)
    d = cfg["datasets"]
    yml = cohort / "gat.yml"
    yml.write_text(f"""name: T
train_type: gnn
eval_type: homo-graph
datasets:
  dataset: "BRCA"
  task: "cancer classification"
  train_path: "{d['train_path']}"
  eval_path: "{d['eval_path']}"
  valid_path: "{d['valid_path']}"
  normal_path: "{d['normal_path']}"
checkpoint:
  path: "{cfg['checkpoint']['path']}"
optimizer:
  opt_method: "ADAM"
  lr: 0.001
  weight_decay: 0.005
GNN:
  name: "GAT"
  num_layers: 2
  in_dim: {D}
  hidden_dim: 16
  out_dim: 2
  num_heads: 2
  num_out_heads: 1
  feat_drop: 0.2
  attn_drop: 0.2
  negative_slope: 0.2
  residual: True
  graph_pooling_type: "mean"
train:
  num_epochs: 1
  batch_size: 2
  loss: "CE"
""")
    stats = main.main(["-config", str(yml), "-device", "cpu"])
    got = main.main(["-config", str(yml), "-mode", "eval", "-device", "cpu"])
    np.testing.assert_allclose(
        got, [stats[f"Testing {m}"] for m in
              ("Accuracy", "F1", "Precision", "Recall", "AUC")], atol=1e-5)
