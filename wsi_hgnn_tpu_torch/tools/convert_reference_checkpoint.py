"""Convert a reference TRAINED MODEL checkpoint for the port
(counterpart of tools/convert_reference_checkpoint.py; the key maps are
copies, so the port imports nothing of the JAX package):

    python -m wsi_hgnn_tpu_torch.tools.convert_reference_checkpoint \
        -config configs/BRCA/HEAT4_kimia_classification_v2.yml \
        --in /path/to/reference_ckpt/1/model_v42.pt \
        --out /path/to/new_ckpt_dir     # default: the config's checkpoint.path

The reference saves `model_v{N}.pt`, a raw torch `state_dict()` of its
DGL model, under its versioned checkpoint directory. This tool maps those
weights onto the flax-layout parameter trees both packages use (numpy
leaves, written as flax msgpack by the port's CheckpointManager), so a
checkpoint it writes is served and evaluated by either package
(`python -m wsi_hgnn_tpu_torch.tools.serve`, `main -mode eval`) without
retraining. Graphs convert with tools/convert_reference_graphs.py.

Supported models, the reference parser's buildable set: HEAT2 / HEAT4 /
HGT / HetRGCN / GCN / GAT / GIN / GCN_NTPool. Layout facts:

  * torch nn.Linear stores weight [out, in]; a flax Dense kernel is
    [in, out], so every Linear transposes (`linear_w`).
  * per-node-type ModuleList linears (`adapt_ws.{t}`,
    `gcs.{i}.k_linears.{t}`) stack into TypedDense kernels [T, in, out];
    per-type ModuleDicts are keyed by str(type).
  * the reference enumerates canonical relations as `for r in
    config.edge_types for s in range(T) for t in range(T)`, while both
    packages fix rel = esign*T*T + s*T + t with esign pos=1/neg=0:
    relation-indexed tensors permute their edge-type blocks by the
    config's edge_types order (`_rel_perm`).
  * DGL GraphConv stores weight [in, out] (no transpose) and one bias.
  * LinearAttentionBlock's op is Conv1d(C, 1, 1, bias=False): weight
    [1, C, 1] -> kernel [C, 1].
  * DGL GATConv: fc.weight [heads*out, in] (transposed), attn_l/attn_r
    [1, heads, out], bias [heads*out] -> [heads, out].
  * DGL GINConv: `layers.{i}.eps` and ApplyNodeFunc's MLP and BatchNorms;
    running_mean/var go to `batch_stats`.
  * reference parameters no forward uses (GCN/GIN/NTPool's extra
    linears_prediction, HGT's `out`, NTPool's `classify`) are dropped.

`validate_state` builds the configured model of the port, requires the
converted tree to match its structure and shapes, loads it through
`convert.load_flax_variables` and runs one forward.
"""
from __future__ import annotations

import argparse
from typing import Dict, Sequence

import numpy as np

from ..models.featurizers.convert import (linear_w, load_torch_state_dict,
                                          strip_dataparallel)


def _lin(sd: Dict, prefix: str):
    """torch Linear -> (kernel [in, out], bias [out])."""
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return linear_w(w), b


def _typed(sd: Dict, fmt: str, n_types: int) -> Dict[str, np.ndarray]:
    """Per-type torch Linears -> TypedDense {kernel [T,in,out], bias [T,out]}."""
    ks, bs = zip(*(_lin(sd, fmt.format(t=t)) for t in range(n_types)))
    return {"kernel": np.stack(ks), "bias": np.stack(bs)}


def _rel_perm(edge_types: Sequence[str], n_types: int) -> np.ndarray:
    """Index map our_rel -> reference_rel for [R]-leading tensors.

    ours:      rel = esign*T*T + s*T + t   (esign: neg=0, pos=1)
    reference: rel = r_idx*T*T + s*T + t   (r_idx = position in edge_types)
    """
    sign_of = {"neg": 0, "pos": 1}
    r_idx_of_sign = {sign_of[r]: i for i, r in enumerate(edge_types)}
    tt = n_types * n_types
    perm = np.empty(2 * tt, np.int64)
    for esign in (0, 1):
        base = esign * tt
        ref_base = r_idx_of_sign[esign] * tt
        perm[base : base + tt] = np.arange(ref_base, ref_base + tt)
    return perm


def convert_heat(sd: Dict, n_layers: int, n_types: int,
                 heat4: bool) -> Dict:
    """HEATNet2/HEATNet4 (reference models/HEATNet2.py, HEATNet4.py:140-193)."""
    params: Dict = {"adapt_ws": _typed(sd, "adapt_ws.{t}", n_types)}
    for i in range(n_layers):
        layer = {
            name: _typed(sd, f"gcs.{i}.{name}.{{t}}", n_types)
            for name in ("k_linears", "q_linears", "v_linears", "a_linears")
        }
        ek, eb = _lin(sd, f"gcs.{i}.e_linear")
        layer["e_linear"] = {"kernel": ek, "bias": eb}
        layer["skip"] = np.asarray(sd[f"gcs.{i}.skip"], np.float32)
        params[f"gcs_{i}"] = layer
    params["linears_prediction"] = _typed(
        sd, "linears_prediction.{t}", n_types
    )
    if heat4:
        for t in range(n_types):
            w = np.asarray(sd[f"attn.{t}.op.weight"], np.float32)  # [1, C, 1]
            params[f"attn_{t}"] = {"op": {"kernel": w[0]}}
        for head in ("head_2", "head_1", "head"):
            k, b = _lin(sd, head)
            params[head] = {"kernel": k, "bias": b}
    return params


def convert_hgt(sd: Dict, n_layers: int, n_types: int,
                edge_types: Sequence[str]) -> Dict:
    """HGT (reference models/HGT.py:21-156)."""
    perm = _rel_perm(edge_types, n_types)
    params: Dict = {"adapt_ws": _typed(sd, "adapt_ws.{t}", n_types)}
    for i in range(n_layers):
        layer = {
            name: _typed(sd, f"gcs.{i}.{name}.{{t}}", n_types)
            for name in ("k_linears", "q_linears", "v_linears", "a_linears")
        }
        layer["norms"] = {
            "scale": np.stack([
                np.asarray(sd[f"gcs.{i}.norms.{t}.weight"], np.float32)
                for t in range(n_types)
            ]),
            "bias": np.stack([
                np.asarray(sd[f"gcs.{i}.norms.{t}.bias"], np.float32)
                for t in range(n_types)
            ]),
        }
        for rel_name in ("relation_att", "relation_msg", "relation_pri"):
            layer[rel_name] = np.asarray(
                sd[f"gcs.{i}.{rel_name}"], np.float32
            )[perm]
        layer["skip"] = np.asarray(sd[f"gcs.{i}.skip"], np.float32)
        params[f"gcs_{i}"] = layer
    # per-layer per-ntype readout heads: linears_prediction.{t}.{layer}
    # (ModuleDict of ModuleLists, HGT.py:141-156)
    for i in range(n_layers):
        params[f"pred_{i}"] = _typed(
            sd, f"linears_prediction.{{t}}.{i}", n_types
        )
    return params


def convert_hetrgcn(sd: Dict, n_layers: int, n_types: int,
                    edge_types: Sequence[str]) -> Dict:
    """HetRGCN (reference models/HetRGCN.py:13-125; relation Linears are a
    ModuleDict keyed by str(canonical index), parser.py:103-122)."""
    perm = _rel_perm(edge_types, n_types)
    params: Dict = {"adapt_ws": _typed(sd, "adapt_ws.{t}", n_types)}
    n_rel = 2 * n_types * n_types
    for i in range(n_layers):
        ks, bs = [], []
        for our_rel in range(n_rel):
            k, b = _lin(sd, f"layers.{i}.weight.{int(perm[our_rel])}")
            ks.append(k)
            bs.append(b)
        params[f"layer_{i}"] = {"kernel": np.stack(ks), "bias": np.stack(bs)}
    for i in range(n_layers):
        params[f"pred_{i}"] = _typed(
            sd, f"linears_prediction.{{t}}.{i}", n_types
        )
    return params


def _graphconv(sd: Dict, i: int) -> Dict:
    """DGL GraphConv `layers.{i}` -> conv_{i} (weight [in, out] is NOT
    transposed; one post-aggregation bias, like DGL)."""
    w = np.asarray(sd[f"layers.{i}.weight"], np.float32)
    b = np.asarray(sd[f"layers.{i}.bias"], np.float32)
    return {"weight": {"kernel": w}, "bias": b}


def convert_gcn(sd: Dict, n_layers: int, pooling: str = "att") -> Dict:
    """GCN (reference models/GCN.py:15-79; DGL GraphConv weight [in, out])."""
    params: Dict = {}
    for i in range(n_layers):
        params[f"conv_{i}"] = _graphconv(sd, i)
    # linears_prediction.{n_layers} exists in the reference state dict but
    # its forward never uses it (GCN.py:68-77) — dropped
    for i in range(n_layers):
        k, b = _lin(sd, f"linears_prediction.{i}")
        params[f"pred_{i}"] = {"kernel": k, "bias": b}
    k, b = _lin(sd, "classify")
    params["classify"] = {"kernel": k, "bias": b}
    if pooling == "att":
        _att_pools(sd, params, n_layers + 1)
    return params


def _bn(sd: Dict, prefix: str):
    """torch BatchNorm1d -> (params {scale, bias}, stats {mean, var})."""
    return (
        {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
         "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)},
        {"mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
         "var": np.asarray(sd[f"{prefix}.running_var"], np.float32)},
    )


def _att_pools(sd: Dict, params: Dict, n_pools: int) -> None:
    """graph_pooling_type='att': DGL GlobalAttentionPooling gate Linears
    (`pools.{i}.gate_nn`, reference GCN.py:52-58) -> pool_{i}/gate_nn."""
    for i in range(n_pools):
        k, b = _lin(sd, f"pools.{i}.gate_nn")
        params[f"pool_{i}"] = {"gate_nn": {"kernel": k, "bias": b}}


def convert_gat(sd: Dict, n_layers: int, pooling: str = "att") -> Dict:
    """GAT (reference models/GAT.py:18-93; DGL GATConv layouts above)."""
    params: Dict = {}
    for i in range(n_layers + 1):
        fc = np.asarray(sd[f"layers.{i}.fc.weight"], np.float32)  # [H*out, in]
        attn_l = np.asarray(sd[f"layers.{i}.attn_l"], np.float32)
        attn_r = np.asarray(sd[f"layers.{i}.attn_r"], np.float32)
        heads, out = attn_l.shape[1], attn_l.shape[2]
        bias = np.asarray(sd[f"layers.{i}.bias"], np.float32).reshape(heads, out)
        params[f"gat_{i}"] = {
            "fc": {"kernel": fc.T},
            "attn_l": attn_l, "attn_r": attn_r, "bias": bias,
        }
    for i in range(n_layers + 1):
        k, b = _lin(sd, f"linears_prediction.{i}")
        params[f"pred_{i}"] = {"kernel": k, "bias": b}
    if pooling == "att":
        _att_pools(sd, params, n_layers + 1)
    return params


def convert_gin(sd: Dict, n_layers: int, num_mlp_layers: int,
                pooling: str = "sum"):
    """GIN (reference models/GIN.py:76-177). Returns (params, batch_stats)
    — BatchNorm running statistics live in the flax batch_stats collection
    and matter at eval time."""
    params: Dict = {}
    stats: Dict = {}
    for i in range(n_layers - 1):
        ref = f"layers.{i}.apply_func"
        mlp_p: Dict = {}
        mlp_s: Dict = {}
        if num_mlp_layers == 1:
            # a 1-layer reference MLP is a single Linear named `linear`
            # (GIN.py:41-49); ours matches (models.homogeneous.GINMLP)
            k, b = _lin(sd, f"{ref}.mlp.linear")
            mlp_p["linear"] = {"kernel": k, "bias": b}
        else:
            for j in range(num_mlp_layers):
                k, b = _lin(sd, f"{ref}.mlp.linears.{j}")
                mlp_p[f"linears_{j}"] = {"kernel": k, "bias": b}
            for j in range(num_mlp_layers - 1):
                p, st = _bn(sd, f"{ref}.mlp.batch_norms.{j}")
                mlp_p[f"bn_{j}"] = p
                mlp_s[f"bn_{j}"] = st
        bn_p, bn_s = _bn(sd, f"{ref}.bn")
        params[f"gin_{i}"] = {
            "mlp": mlp_p, "bn": bn_p,
            "eps": np.float32(np.asarray(sd[f"layers.{i}.eps"])).reshape(()),
        }
        # single-layer MLPs have no BN stats; an empty 'mlp' entry would
        # mismatch the model's batch_stats tree structure
        stats[f"gin_{i}"] = ({"mlp": mlp_s, "bn": bn_s} if mlp_s
                             else {"bn": bn_s})
    # linears_prediction has num_layers entries but the forward uses only
    # the first num_layers-1 + classify (GIN.py:83-89) — extras dropped
    for i in range(n_layers - 1):
        k, b = _lin(sd, f"linears_prediction.{i}")
        params[f"pred_{i}"] = {"kernel": k, "bias": b}
    k, b = _lin(sd, "classify")
    params["classify"] = {"kernel": k, "bias": b}
    if pooling == "att":
        # the GIN forward uses pools 0..n_layers-2 in its layer loop and
        # pools[-1] (= pools.{n_layers}) for classify; pools.{n_layers-1}
        # is never used (GIN.py:83-89) — our names: pool_{i} + pool_last
        _att_pools(sd, params, n_layers - 1)
        k, b = _lin(sd, f"pools.{n_layers}.gate_nn")
        params["pool_last"] = {"gate_nn": {"kernel": k, "bias": b}}
    return params, stats


def convert_ntpool(sd: Dict, n_layers: int, n_types: int) -> Dict:
    """NTPoolGCN (reference models/GCN_NTPool.py:16-123): GraphConv stack
    + per-(layer, ntype) readout heads as FLAT stacked params."""
    params: Dict = {}
    for i in range(n_layers):
        params[f"conv_{i}"] = _graphconv(sd, i)
    for i in range(n_layers):
        params[f"pred_{i}"] = _typed(
            sd, f"linears_prediction.{{t}}.{i}", n_types
        )
    return params


def convert_gnn_state_dict(config_gnn: Dict, sd: Dict) -> Dict:
    """Reference torch state dict -> {'params': ..., 'batch_stats': ...}
    for the model named by the GNN config section."""
    sd = strip_dataparallel(sd)
    name = config_gnn["name"]
    n_types = int(config_gnn.get("n_node_types", 6))
    n_layers = int(config_gnn["num_layers"])
    edge_types = list(config_gnn.get("edge_types", ["pos", "neg"]))
    stats: Dict = {}
    if name in ("HEAT2", "HEAT4"):
        params = convert_heat(sd, n_layers, n_types, heat4=name == "HEAT4")
    elif name == "HGT":
        params = convert_hgt(sd, n_layers, n_types, edge_types)
    elif name == "HetRGCN":
        params = convert_hetrgcn(sd, n_layers, n_types, edge_types)
    elif name == "GCN":
        params = convert_gcn(
            sd, n_layers, config_gnn.get("graph_pooling_type", "att")
        )
    elif name == "GAT":
        params = convert_gat(
            sd, n_layers, config_gnn.get("graph_pooling_type", "att")
        )
    elif name == "GIN":
        params, stats = convert_gin(
            sd, n_layers, int(config_gnn["num_mlp_layers"]),
            config_gnn.get("graph_pooling_type", "sum"),
        )
    elif name == "GCN_NTPool":
        params = convert_ntpool(sd, n_layers, n_types)
    else:
        raise NotImplementedError(
            f"checkpoint conversion not implemented for {name!r}"
        )
    return {"params": params, "batch_stats": stats}


def _shapes(tree: Dict, prefix: str = "") -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def validate_state(config_gnn: Dict, state: Dict) -> None:
    """Build the configured model of the port and require the converted
    tree to match its structure and shapes exactly, then load it and run
    one forward on a tiny graph: a config/checkpoint mismatch (a HEAT4
    state dict converted with a HEAT2 config) fails here with a readable
    diff, not later as wrong served outputs."""
    import torch

    from .. import convert
    from ..config import parse_gnn_model
    from ..graph.build import build_batch_device
    from ..graph.typed_graph import to_homogeneous

    model, is_hetero = parse_gnn_model(config_gnn)
    want = convert.to_flax_variables(model)
    for col in want:
        w = _shapes(want[col])
        got = _shapes(state.get(col) or {})
        if w != got:
            missing = sorted(set(w) - set(got))
            extra = sorted(set(got) - set(w))
            wrong = sorted(
                f"{p}: converted {got[p]} vs model {w[p]}"
                for p in set(w) & set(got) if w[p] != got[p])
            raise ValueError(
                f"converted {col!r} does not match the "
                f"{config_gnn['name']} model: "
                f"missing={missing} extra={extra} shape-mismatch={wrong}")
    convert.load_flax_variables(
        model, {col: tree for col, tree in state.items() if tree})
    n_types = int(config_gnn.get("n_node_types", 6))
    rng = np.random.RandomState(0)
    g = build_batch_device(
        torch.from_numpy(rng.randn(1, 32, int(config_gnn["in_dim"])).astype(
            np.float32)),
        torch.from_numpy(rng.randint(0, n_types, (1, 32))),
        torch.ones((1, 32), dtype=torch.bool), 4, n_types)
    with torch.no_grad():
        logits = model.eval()(g if is_hetero else to_homogeneous(g))
    if not bool(torch.isfinite(logits).all()):
        raise ValueError("the converted model's logits are not finite")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-config", required=True, help="training YAML")
    p.add_argument("--in", dest="inp", required=True,
                   help="reference model_v{N}.pt (torch state dict)")
    p.add_argument("--out", default="",
                   help="output checkpoint dir (default: config "
                        "checkpoint.path)")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..train.checkpoint import CheckpointManager

    config = load_config(args.config)
    state = convert_gnn_state_dict(config["GNN"],
                                   load_torch_state_dict(args.inp))
    validate_state(config["GNN"], state)
    out = args.out or config["checkpoint"]["path"]
    cm = CheckpointManager(out)
    cm.write_new_version(config, state, {"Epoch": 1})
    print(f"wrote converted checkpoint v{cm.version} to {out}")


if __name__ == "__main__":
    main()
