"""Prov-GigaPath's LongNet slide encoder in the port
(wsi_hgnn_tpu_torch/models/mil/longnet.py, `train_mil --model gigapath`)
on the CPU, against the benchmark's plain reference
(benchmark/reference/longnet.py, imported by path: one reference for the
benchmark and the tests). The JAX package has no LongNet.

Small size with every mechanism present: 16 heads of 8, 2 layers, all
five (segment, ratio) pairs with segments [16, 32, 64, 128, 256], so that
the pairs clamp to the slide, pad its last segment and pad segments to
a multiple of the ratio at T = 100-300 tokens (a multiple of no segment
length). Tolerance: a relative L2 of 1e-5, both in f32 (the CPU's flash
attention and torch's LayerNorm against the reference's written-out
forms sum in another order); a gradient is held to it over the larger of
its own norm and the median leaf's, as the benchmark's grad_gap holds it
(a key bias moves the scores of a segment's real keys alike: its
gradient, from the pad rows alone, is a thousandth of the median leaf's
or round-off). Each planted fault moves the logits by over 1e-3.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wsi_hgnn_tpu_torch import train_mil
from wsi_hgnn_tpu_torch.models.mil import longnet as tln
import port_threads  # noqa: F401  (torch threads per test worker)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import longnet as ref  # noqa: E402

SEGMENTS = [16, 32, 64, 128, 256]
NGRIDS = 40
ARCH = dict(ref.ARCH, in_dim=24, dim=128, depth=2, heads=16, mlp_hidden=512,
            segment_lengths=SEGMENTS, ngrids=NGRIDS)
SIZES = dict(dim=128, depth=2, heads=16, mlp_ratio=4.0,
             segment_lengths=SEGMENTS, ngrids=NGRIDS)
OPT = {"lr": 2e-3, "weight_decay": 0.05, "layer_decay": 0.95}
TOL = 1e-5


def rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def weights(seed=3):
    """The benchmark's seeded weights, with a head at fan-in scale (the
    cell's starts near 0), so that the logits read the slide embedding."""
    w = ref.make_weights(ref.spec(ARCH), seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    w["head.weight"] = (torch.randn(w["head.weight"].shape, generator=g)
                        / ARCH["dim"] ** 0.5)
    return w


def model_with(w):
    m = tln.LongNetViT(in_dim=ARCH["in_dim"], **SIZES)
    m.load_state_dict(w, strict=True)
    return m


def slide(t, seed=None):
    g = torch.Generator().manual_seed(t if seed is None else seed)
    x = torch.randn(t - 1, ARCH["in_dim"], generator=g)
    c = torch.randint(0, NGRIDS * 256, (t - 1, 2), generator=g)
    return x, c


@pytest.mark.parametrize("t", [100, 173, 257, 300])
def test_forward_and_every_gradient_match_the_reference(t):
    w = weights()
    m = model_with(w)
    x, c = slide(t)
    got = m(x, c)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = ref.logits(leaves, x, c, ARCH)
    assert rel(got.detach(), want.detach()) <= TOL
    got.sum().backward()
    want.sum().backward()
    grads = {k: p.grad for k, p in m.named_parameters()}
    med = float(np.median([float(leaves[k].grad.norm()) for k in grads]))
    for k, g in grads.items():
        g_ref = leaves[k].grad
        err = float((g - g_ref).norm()) / max(float(g_ref.norm()), med)
        assert err <= TOL, (k, err)


def mae_2d_sincos(embed_dim, grid_size):
    """MAE's get_2d_sincos_pos_embed(embed_dim, grid_size, cls_token=True),
    in its numpy form."""
    def one_d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_size, dtype=np.float32)
    gw = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid_size, grid_size)
    emb = np.concatenate([one_d(embed_dim // 2, grid[0]),
                          one_d(embed_dim // 2, grid[1])], axis=1)
    return np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)


def test_position_rows_are_the_mae_table():
    """Row p = ngrids floor(C0 / 256) + floor(C1 / 256) + 1 of MAE's table
    (as gigapath's coords_to_pos indexes it), at the published width."""
    table = mae_2d_sincos(768, NGRIDS).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    coords = torch.randint(0, NGRIDS * 256, (500, 2), generator=g)
    coords[0] = torch.tensor([0, 0])
    coords[1] = torch.tensor([NGRIDS * 256 - 1, 255])
    pos = (coords[:, 0] // 256) * NGRIDS + coords[:, 1] // 256 + 1
    want = torch.from_numpy(table[pos.numpy()])
    got = tln.sincos_rows(tln.sincos_table(NGRIDS, 768), coords, 256)
    assert torch.equal(got, want)
    arch = dict(ref.ARCH, ngrids=NGRIDS)
    assert torch.equal(ref.position_rows(coords, arch), want)


def test_segment_lengths_are_gigapaths():
    want = [1024, 5792, 32768, 185363, 1048576]
    assert tln.get_optimal_segment_length(262144, 256) == want
    assert ref.ARCH["segment_lengths"] == want
    attn = tln.LongNetViT().encoder.layers[0].self_attn
    assert attn.pairs == list(zip(want, [1, 2, 4, 8, 16]))


@pytest.mark.parametrize("reading", ref.FAULTS + ("mask_pads",))
def test_each_fault_moves_the_logits(reading):
    """At T = 145 the clamped pairs' one segment ends in pad rows, so
    masking them shows too (through the first layer's rows)."""
    w = weights()
    x, c = slide(145)
    with torch.no_grad():
        want = ref.logits(w, x, c, ARCH)
        kw = {"mask_pads": True} if reading == "mask_pads" else {"fault": reading}
        moved = ref.logits(w, x, c, ARCH, **kw)
    assert rel(moved, want) > 1e-3, reading


def write_bags(root, sizes, labels, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for i, (n, y) in enumerate(zip(sizes, labels)):
        np.savez(root / f"slide{i}.npz",
                 feat=rng.standard_normal((n, ARCH["in_dim"])).astype(np.float32),
                 xy=rng.integers(0, NGRIDS, (n, 2)))
        rows.append(f"slide{i},{y}")
    (root / "labels.csv").write_text("name,label\n" + "\n".join(rows) + "\n")


def test_train_mil_one_epoch_matches_the_reference_steps(tmp_path, monkeypatch):
    """`train_mil --model gigapath` through its CLI: fold 0's epoch steps
    three bags; its losses and each leaf's change over the epoch against
    the reference's AdamW steps from the same initial weights, in the
    same order."""
    write_bags(tmp_path, [120, 99, 150, 180, 131, 77], [0, 0, 1, 1, 1, 1])
    built, losses = [], []
    real_make, real_step = train_mil.make_gigapath, train_mil.gigapath_train_step

    def make(in_dim, num_classes, device, seed=0, **arch):
        m = real_make(in_dim, num_classes, device, seed, **SIZES)
        built.append({k: v.detach().clone() for k, v in m.state_dict().items()})
        return m

    def step(*args):
        loss = real_step(*args)
        losses.append(float(loss))
        return loss

    monkeypatch.setattr(train_mil, "make_gigapath", make)
    monkeypatch.setattr(train_mil, "gigapath_train_step", step)
    out = train_mil.main(["--model", "gigapath", "--feats-dir", str(tmp_path),
                          "--labels", str(tmp_path / "labels.csv"), "--folds",
                          "2", "--epochs", "1", "--seed", "3", "--device",
                          "cpu", "--save-dir", str(tmp_path / "folds")])
    assert out["model"] == "gigapath" and len(built) == 2 and len(losses) == 6

    bags, labels, _, coords = train_mil.load_bags(str(tmp_path),
                                                  str(tmp_path / "labels.csv"))
    train_idx = train_mil.stratified_kfold_split(labels, 2)[0][0]
    order = train_idx[np.random.RandomState(3).permutation(len(train_idx))]
    pixels = train_mil.gigapath_coords(coords)
    want = ref.reference_steps(built[0], [(bags[i], pixels[i], labels[i])
                                          for i in order], ARCH, OPT, "cpu")
    assert max(abs(a - b) / b for a, b in zip(losses[:3], want["losses"])) <= TOL
    after = torch.load(tmp_path / "folds" / "gigapath_fold0.pt")
    med = float(np.median([float(g.norm()) for g in want["grad1"].values()]))
    for k, w0 in built[0].items():
        if float(want["grad1"][f"params/{k}"].norm()) < 1e-2 * med:
            continue   # moved by round-off's sign under Adam
        d_got, d_want = after[k] - w0, want["params"][f"params/{k}"] - w0
        assert rel(d_got, d_want) <= 1e-4, k


def published_names(depth):
    names = ["cls_token", "patch_embed.proj.weight", "patch_embed.proj.bias",
             "encoder.layer_norm.weight", "encoder.layer_norm.bias",
             "norm.weight", "norm.bias"]
    for i in range(depth):
        b = f"encoder.layers.{i}."
        for part in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj", "self_attn.inner_attn_ln",
                     "self_attn_layer_norm", "ffn.fc1", "ffn.fc2",
                     "ffn.ffn_layernorm", "final_layer_norm"):
            names += [b + part + ".weight", b + part + ".bias"]
    return names


def test_a_state_dict_with_the_published_names_loads():
    """The slide encoder's torchscale and gigapath names (and a pos_embed
    table, which the port computes) load; the head is the port's own."""
    src = model_with(weights(4))
    sd = {k: v for k, v in src.state_dict().items() if not k.startswith("head.")}
    assert sorted(sd) == sorted(published_names(ARCH["depth"]))
    sd["pos_embed"] = torch.zeros(1, NGRIDS ** 2 + 1, ARCH["dim"])
    dst = model_with(weights(5))
    dst.load_slide_encoder(sd)
    for k, v in sd.items():
        if k != "pos_embed":
            assert torch.equal(dst.state_dict()[k], v), k
    del sd["encoder.layers.1.ffn.ffn_layernorm.bias"]
    with pytest.raises(KeyError):
        dst.load_slide_encoder(sd)


def test_train_mil_refuses_bags_without_coordinates(tmp_path):
    write_bags(tmp_path, [50, 60], [0, 1])
    with np.load(tmp_path / "slide0.npz") as z:
        np.savez(tmp_path / "slide0.npz", feat=z["feat"])
    with pytest.raises(SystemExit, match="coordinates"):
        train_mil.main(["--model", "gigapath", "--feats-dir", str(tmp_path),
                        "--labels", os.fspath(tmp_path / "labels.csv"),
                        "--device", "cpu"])


@pytest.mark.parametrize("xy,match", [
    (np.array([[0, 0], [256, 0], [512, 256]]), "pixels"),
    (np.array([[0, 0], [3, 1], [1000, 2]]), "outside"),
    (np.array([[0, 0], [-1, 1], [2, 2]]), "outside")])
def test_train_mil_refuses_coordinates_that_are_not_grid_cells(tmp_path, xy,
                                                               match):
    """`xy` is grid cells (col, row) across train_mil: coordinates in
    pixels, or off the 1000 x 1000 grid, stop the run."""
    write_bags(tmp_path, [50, 60], [0, 1])
    with np.load(tmp_path / "slide1.npz") as z:
        np.savez(tmp_path / "slide1.npz", feat=z["feat"][:3], xy=xy)
    with pytest.raises(SystemExit, match=match):
        train_mil.main(["--model", "gigapath", "--feats-dir", str(tmp_path),
                        "--labels", os.fspath(tmp_path / "labels.csv"),
                        "--device", "cpu"])


def test_gigapath_takes_lr_and_weight_decay_and_gtn_refuses_a_decay(
        tmp_path, monkeypatch):
    """--lr and --weight-decay reach gigapath's AdamW (its defaults 2e-3
    and 0.05 otherwise); gtn's decay is fixed, so it refuses the flag."""
    write_bags(tmp_path, [30, 40, 50, 60, 35, 45, 55, 65], [0] * 4 + [1] * 4)
    made = []
    real = train_mil.gigapath_optimizer

    def optimizer(model, device, lr, weight_decay):
        made.append((lr, weight_decay))
        return real(model, device, lr, weight_decay)

    monkeypatch.setattr(train_mil, "make_gigapath",
                        lambda d, c, dev, seed=0: tln.LongNetViT(
                            in_dim=d, n_classes=c, **SIZES))
    monkeypatch.setattr(train_mil, "gigapath_optimizer", optimizer)
    base = ["--model", "gigapath", "--feats-dir", str(tmp_path), "--labels",
            os.fspath(tmp_path / "labels.csv"), "--folds", "2", "--epochs",
            "1", "--device", "cpu"]
    train_mil.main(base)
    train_mil.main(base + ["--lr", "1e-4", "--weight-decay", "0.1"])
    assert made == [(2e-3, 0.05)] * 2 + [(1e-4, 0.1)] * 2
    with pytest.raises(SystemExit, match="weight-decay"):
        train_mil.main(base[:1] + ["gtn"] + base[2:] + ["--weight-decay",
                                                        "0.1"])


def test_gigapath_on_bags_from_simclr_extraction(tmp_path, monkeypatch):
    """The port's own bag writer (`pretrain_simclr --extract`, tiles named
    `{col}_{row}.jpeg`) into `train_mil --model gigapath`: each tile
    reaches the model at its grid cell x 256 px, so tiles on distinct
    cells get distinct position rows."""
    from PIL import Image

    from wsi_hgnn_tpu_torch.tools import pretrain_simclr

    rng = np.random.RandomState(0)
    patches, rows = tmp_path / "patches", []
    for i in range(8):
        d = patches / f"s{i}"
        d.mkdir(parents=True)
        for col, row in [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (3, 2)]:
            img = rng.randint(0, 255, (24, 24, 3)).astype(np.uint8)
            Image.fromarray(img).save(d / f"{col}_{row}.jpeg")
        rows.append(f"s{i},{i % 2}")
    (tmp_path / "labels.csv").write_text("\n".join(rows) + "\n")
    common = ["--patch-dir", str(patches), "--backbone", "tiny", "--batch",
              "4", "--image-size", "32", "--device", "cpu"]
    ckpt = pretrain_simclr.main(common + [
        "--out", str(tmp_path / "simclr"), "--epochs", "1", "--lr", "1e-3",
        "--warmup-epochs", "1", "--proj-dim", "16", "--train-backbone"])
    pretrain_simclr.main(common + ["--extract", "--ckpt", ckpt, "--out",
                                   str(tmp_path / "feats")])

    seen = []
    real_step = train_mil.gigapath_train_step
    monkeypatch.setattr(train_mil, "make_gigapath",
                        lambda d, c, dev, seed=0: tln.LongNetViT(
                            in_dim=d, n_classes=c, **SIZES))

    def step(model, opt, feats, coords, label, device):
        seen.append(np.asarray(coords))
        return real_step(model, opt, feats, coords, label, device)

    monkeypatch.setattr(train_mil, "gigapath_train_step", step)
    train_mil.main(["--model", "gigapath", "--feats-dir",
                    str(tmp_path / "feats"), "--labels",
                    str(tmp_path / "labels.csv"), "--folds", "2",
                    "--epochs", "1", "--device", "cpu"])
    assert seen
    table = tln.sincos_table(NGRIDS, SIZES["dim"])
    for px in seen:
        cells = np.unique(px // 256, axis=0)
        assert len(cells) == len(px) == 6 and (px % 256 == 0).all()
        pos = tln.sincos_rows(table, torch.as_tensor(px), 256)
        assert len(torch.unique(pos, dim=0)) == len(px)
