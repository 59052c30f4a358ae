"""Model selection from a config's GNN section (counterpart of
wsi_hgnn_tpu/config.py::parse_lattice_twin). Takes a plain dict, so the
port needs no YAML reader."""
from __future__ import annotations

from typing import Dict, Optional


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
