"""Config system and factories (counterpart of wsi_hgnn_tpu/config.py):
YAML loading, the model switch, optimizers and losses.

The port reads the shipped `configs/` with its own reader, since the
machines it runs on need not have PyYAML. It takes the subset those files
use and raises on anything else: nested maps indented by spaces, `#`
comments (whole-line and trailing), quoted and bare strings, ints, floats
(`0.00001`, `1e-5`), `True`/`False`, empty values (None) and one-line flow
lists of scalars (`edge_types: ["pos", "neg"]`). Maps come back as
`OrderedDict`s in file order, equal to what the JAX package's PyYAML
loader returns for every file under `configs/`. One deliberate difference:
PyYAML reads an exponent without a dot (`1e-5`) as a string, which no
numeric key can use; here it is a float.

Optimizers are torch's own with the reference's coupling (weight decay is
L2 added to the gradient, as in the JAX package's optax chains).
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------- #
# YAML subset
# --------------------------------------------------------------------- #
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?(([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?"
                    r"|[0-9]+[eE][-+]?[0-9]+)$")
_BARE = re.compile(r"[A-Za-z_./][A-Za-z0-9_./\-]*$")
_BOOL = {"True": True, "true": True, "TRUE": True,
         "False": False, "false": False, "FALSE": False}
# bare words PyYAML resolves to something other than a string
_RESERVED = {"yes", "no", "on", "off", "y", "n", "null", "~"}


class ConfigSyntaxError(ValueError):
    pass


def _strip_comment(text: str, where: str) -> str:
    """`text` with a trailing ` #...` comment removed (outside quotes)."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        raise ConfigSyntaxError(f"{where}: unterminated quote")
    return text.rstrip()


def _scalar(tok: str, where: str):
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        body = tok[1:-1]
        if "\\" in body or '"' in body:
            raise ConfigSyntaxError(f"{where}: escapes are not supported")
        return body
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        body = tok[1:-1]
        if "'" in body.replace("''", ""):
            raise ConfigSyntaxError(f"{where}: stray quote in {tok!r}")
        return body.replace("''", "'")
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if _BARE.match(tok) and tok.lower() not in _RESERVED:
        return tok
    raise ConfigSyntaxError(f"{where}: unsupported value {tok!r}")


def _flow_list(tok: str, where: str) -> List:
    body = tok[1:-1].strip()
    if not body:
        return []
    if any(c in body for c in "[]{}"):
        raise ConfigSyntaxError(f"{where}: nested flow collections")
    return [_scalar(item.strip(), where) for item in body.split(",")]


def _value(text: str, where: str):
    if text.startswith("["):
        if not text.endswith("]"):
            raise ConfigSyntaxError(f"{where}: a flow list must fit one line")
        return _flow_list(text, where)
    if text[0] in "{&*!|>%@`":
        raise ConfigSyntaxError(f"{where}: unsupported YAML {text!r}")
    return _scalar(text, where)


def loads_config(text: str, source: str = "<string>") -> OrderedDict:
    """Parse a config's text into nested OrderedDicts."""
    lines: List[Tuple[int, str, str]] = []  # (indent, content, where)
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{no}"
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ConfigSyntaxError(f"{where}: tab indentation")
        content = _strip_comment(raw.strip(), where)
        if not content:
            continue
        lines.append((len(raw) - len(raw.lstrip(" ")), content, where))
    if not lines:
        raise ConfigSyntaxError(f"{source}: empty config")

    pos = 0

    def block(indent: int) -> OrderedDict:
        nonlocal pos
        pairs = []
        while pos < len(lines):
            ind, content, where = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise ConfigSyntaxError(f"{where}: unexpected indentation")
            m = _KEY.match(content)
            if m is None:
                raise ConfigSyntaxError(f"{where}: expected 'key: value', got "
                                        f"{content!r}")
            pos += 1
            key, rest = m.group(1), m.group(2)
            if rest:
                pairs.append((key, _value(rest, where)))
            elif pos < len(lines) and lines[pos][0] > indent:
                pairs.append((key, block(lines[pos][0])))
            else:
                pairs.append((key, None))
        return OrderedDict(pairs)

    out = block(lines[0][0])
    if pos != len(lines):
        raise ConfigSyntaxError(f"{lines[pos][2]}: dedent below the top level")
    return out


def load_config(path) -> OrderedDict:
    """Ordered config load (the JAX package's load_config)."""
    with open(path) as f:
        return loads_config(f.read(), source=str(path))


# --------------------------------------------------------------------- #
# factories
# --------------------------------------------------------------------- #
def parse_lattice_twin(config_gnn: Dict):
    """The lattice HEAT model of a GNN config section, or None when the
    model has no lattice form (not HEAT2/HEAT4, or a pooling other than
    mean/sum/max). Parameter trees match the flax twins name for name."""
    from .models.lattice import HEATNet2Lattice, HEATNet4Lattice

    name = config_gnn["name"]
    if name not in ("HEAT2", "HEAT4"):
        return None
    pooling: Optional[str] = config_gnn.get("graph_pooling_type", "mean")
    if pooling not in ("mean", "sum", "max"):
        return None
    cls = HEATNet2Lattice if name == "HEAT2" else HEATNet4Lattice
    return cls(
        in_dim=int(config_gnn["in_dim"]),
        hidden_dim=int(config_gnn["hidden_dim"]),
        out_dim=int(config_gnn["out_dim"]),
        n_layers=int(config_gnn["num_layers"]),
        n_heads=int(config_gnn["n_heads"]),
        n_node_types=int(config_gnn["n_node_types"]),
        dropout=float(config_gnn["feat_drop"]),
        graph_pooling_type=pooling,
        typed_impl=str(config_gnn.get("typed_impl", "ragged")),
    )


def parse_gnn_model(config_gnn: Dict) -> Tuple[torch.nn.Module, bool]:
    """(model, is_heterogeneous) of a GNN section (the JAX package's
    parse_gnn_model, reference parser.py:48-174): heterogeneous models
    take the typed graph, homogeneous ones its untyped view. Its quirks
    are kept: GAT's residual is off whatever the file says and its heads
    are [num_heads] * num_layers + [num_out_heads]; HGT ignores
    graph_pooling_type; HetRGCN has len(edge_types) edge types; the
    TypedGraph HEAT models default to typed_impl 'onehot'."""
    from .models import (ASAPGCN, GAT, GCN, GIN, HEATNet2, HEATNet4, HGT,
                         HetRGCN, NTPoolGCN)

    c = config_gnn
    name = c["name"]
    if name == "GAT":
        n_layers = int(c["num_layers"])
        heads = [int(c["num_heads"])] * n_layers + [int(c["num_out_heads"])]
        return GAT(n_layers=n_layers, in_dim=int(c["in_dim"]),
                   hidden_dim=int(c["hidden_dim"]), out_dim=int(c["out_dim"]),
                   heads=tuple(heads), feat_drop=float(c["feat_drop"]),
                   attn_drop=float(c["attn_drop"]),
                   negative_slope=float(c["negative_slope"]), residual=False,
                   graph_pooling_type=c["graph_pooling_type"]), False
    if name == "GCN" and c.get("graph_pooling_type") == "asap":
        return ASAPGCN(in_dim=int(c["in_dim"]),
                       hidden_dim=int(c["hidden_dim"]),
                       out_dim=int(c["out_dim"]),
                       n_layers=int(c["num_layers"]),
                       k=int(c.get("pool_k", 32)),
                       dropout=float(c["feat_drop"])), False
    if name == "GCN":
        return GCN(in_dim=int(c["in_dim"]), hidden_dim=int(c["hidden_dim"]),
                   out_dim=int(c["out_dim"]), n_layers=int(c["num_layers"]),
                   dropout=float(c["feat_drop"]),
                   graph_pooling_type=c["graph_pooling_type"]), False
    if name == "GCN_NTPool":
        return NTPoolGCN(in_dim=int(c["in_dim"]),
                         hidden_dim=int(c["hidden_dim"]),
                         out_dim=int(c["out_dim"]),
                         n_node_types=int(c["n_node_types"]),
                         n_layers=int(c["num_layers"]),
                         dropout=float(c["feat_drop"]),
                         graph_pooling_type=c["graph_pooling_type"]), True
    if name == "GIN":
        return GIN(input_dim=int(c["in_dim"]), hidden_dim=int(c["hidden_dim"]),
                   out_dim=int(c["out_dim"]), num_layers=int(c["num_layers"]),
                   num_mlp_layers=int(c["num_mlp_layers"]),
                   final_dropout=float(c["feat_drop"]),
                   graph_pooling_type=c["graph_pooling_type"],
                   neighbor_pooling_type=c["neighbor_pooling_type"]), False
    if name == "HetRGCN":
        return HetRGCN(in_dim=int(c["in_dim"]),
                       hidden_dim=int(c["hidden_dim"]),
                       out_dim=int(c["out_dim"]),
                       n_layers=int(c["num_layers"]),
                       n_node_types=int(c["n_node_types"]),
                       n_edge_types=len(c.get("edge_types", ["neg", "pos"])),
                       graph_pooling_type=c["graph_pooling_type"]), True
    if name == "HGT":
        return HGT(in_dim=int(c["in_dim"]), hidden_dim=int(c["hidden_dim"]),
                   out_dim=int(c["out_dim"]), n_layers=int(c["num_layers"]),
                   n_heads=int(c["num_heads"]),
                   n_node_types=int(c["n_node_types"])), True
    if name in ("HEAT2", "HEAT4"):
        cls = HEATNet2 if name == "HEAT2" else HEATNet4
        return cls(in_dim=int(c["in_dim"]), hidden_dim=int(c["hidden_dim"]),
                   out_dim=int(c["out_dim"]), n_layers=int(c["num_layers"]),
                   n_heads=int(c["n_heads"]),
                   n_node_types=int(c["n_node_types"]),
                   dropout=float(c["feat_drop"]),
                   graph_pooling_type=c["graph_pooling_type"],
                   typed_impl=str(c.get("typed_impl", "onehot"))), True
    raise NotImplementedError(f"This GNN model is not implemented: {name!r}")


def parse_optimizer(config_optim: Dict, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """Optimizer from the `optimizer:` section (reference parser.py:16-45,
    as the JAX package reads it): Adam, Adagrad (lr_decay and weight_decay
    both the config's weight_decay), Adadelta, else SGD."""
    method = str(config_optim["opt_method"]).lower()
    lr = float(config_optim["lr"])
    wd = float(config_optim.get("weight_decay", 0.0))
    if method == "adagrad":
        return torch.optim.Adagrad(params, lr=lr, lr_decay=wd,
                                   weight_decay=wd, eps=1e-10)
    if method == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6,
                                    weight_decay=wd)
    if method == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    return torch.optim.SGD(params, lr=lr, weight_decay=wd)


def parse_loss(config_train: Dict):
    """fn(logits [B, C], labels [B] int64, weights [B]) -> weighted mean.
    'CE' is softmax cross-entropy on logits; 'BCE' is the JAX package's
    repair of the reference's broken branch: per-class BCE of the softmax
    probabilities against the one-hot label."""
    name = config_train["loss"]
    if name == "CE":
        def ce(logits, labels, weights):
            nll = -F.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
            return (nll * weights).sum() / weights.sum().clamp_min(1.0)
        return ce
    if name == "BCE":
        def bce(logits, labels, weights):
            p = torch.softmax(logits, -1)
            onehot = F.one_hot(labels, logits.shape[-1]).to(p.dtype)
            eps = 1e-12
            ll = onehot * torch.log(p + eps) + (1 - onehot) * torch.log(
                1 - p + eps)
            per = -ll.mean(-1)
            return (per * weights).sum() / weights.sum().clamp_min(1.0)
        return bce
    raise NotImplementedError(f"This Loss is not implemented: {name!r}")
