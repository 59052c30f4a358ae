"""Train/val/test split generation (counterpart of
wsi_hgnn_tpu/pipeline/splits.py; a copy, so the port imports nothing of
the JAX package): the reference get_graph.py's GET_TRAINVAL block.

Semantics preserved:
  * classification (COAD/BRCA): normal/tumor stratified 80/10/10;
  * staging: normals and unlabeled cases dropped, 80/10/10 (the COAD
    stage filter omits 'Stage IB', as the reference's does);
  * typing (BRCA): 60/28/12 via the 0.6 then 0.7 double split;
  * camelyon16: tumor*+normal* train, test* split 50/50 into test/val;
  * outputs: out_dir/list_*/{heterogeneous,homogeneous}_{train,test,val}.txt
    path lists. Graph files are .npz.
"""
from __future__ import annotations

import glob
import os
import random
from math import floor
from pathlib import Path
from typing import Dict, List, Tuple

Split = Tuple[List[str], List[str], List[str]]


def _split(files: List[str], frac: float):
    i = floor(len(files) * frac)
    return files[:i], files[i:]


def _read_list(path) -> List[str]:
    with open(path) as f:
        return [l.strip() for l in f.readlines() if l.strip()]


def _graphs(out_dir) -> List[str]:
    return glob.glob(str(Path(out_dir) / "homogeneous" / "*.npz"))


def classification_trainval(out_dir, normal_path, rng: random.Random) -> Split:
    """Normal/tumor-stratified 80/10/10 (COAD_trainval / BRCA_trainval)."""
    graph_list = _graphs(out_dir)
    normal_list = _read_list(normal_path)
    normal_graphs = []
    for normal in normal_list:
        normal_graphs.extend(
            glob.glob(str(Path(out_dir) / "homogeneous" / (normal + "*.npz")))
        )
    # overlapping normal prefixes may match the same file twice
    normal_graphs = sorted(set(normal_graphs))
    tumor_graphs = sorted(set(graph_list) - set(normal_graphs))
    if len(normal_graphs) + len(tumor_graphs) != len(graph_list):
        raise ValueError("removed graph number != total normal graph")
    rng.shuffle(normal_graphs)
    rng.shuffle(tumor_graphs)
    train_t, testval_t = _split(tumor_graphs, 0.8)
    test_t, val_t = _split(testval_t, 0.5)
    train_n, testval_n = _split(normal_graphs, 0.8)
    test_n, val_n = _split(testval_n, 0.5)
    return train_t + train_n, val_t + val_n, test_t + test_n


def _filtered_trainval(out_dir, normal_path, label_path, allowed, sep, fracs,
                       rng: random.Random) -> Split:
    normal_list = _read_list(normal_path)
    mapping = {k: v for k, v in (l.split(sep=sep) for l in _read_list(label_path))}
    graphs = []
    for p in sorted(_graphs(out_dir)):
        # search the FILENAME: a directory named 'TCGA_BRCA' would anchor
        # the barcode slice in the path and silently empty every split
        base = os.path.basename(p)
        pos = base.find("TCGA")
        if pos < 0 or base[pos:pos + 16] in normal_list:
            continue
        lb = mapping.get(base[pos:pos + 12])
        if lb is None or lb not in allowed:
            continue
        graphs.append(p)
    rng.shuffle(graphs)
    train, testval = _split(graphs, fracs[0])
    test, val = _split(testval, fracs[1])
    return train, val, test


# the reference's COAD staging filter omits 'Stage IB'
# (get_graph.py:134-136, 13 entries); only the BRCA filter adds it
# (get_graph.py:168-171, 14 entries) — COAD Stage-IB slides are dropped
_STAGES_COAD = [
    "Stage I", "Stage IA", "Stage II", "Stage IIA", "Stage IIB",
    "Stage IIC", "Stage III", "Stage IIIA", "Stage IIIB", "Stage IIIC",
    "Stage IV", "Stage IVA", "Stage IVB",
]
_STAGES_BRCA = _STAGES_COAD + ["Stage IB"]
_BRCA_TYPES = ["Infiltrating Ductal Carcinoma", "Infiltrating Lobular Carcinoma"]


def staging_trainval(out_dir, normal_path, staging_path, rng,
                     dataset: str = "BRCA") -> Split:
    stages = _STAGES_COAD if dataset == "COAD" else _STAGES_BRCA
    return _filtered_trainval(out_dir, normal_path, staging_path, stages,
                              "\t", (0.8, 0.5), rng)


def typing_trainval(out_dir, normal_path, typing_path, rng, sep="\t") -> Split:
    """BRCA typing uses the 0.6/0.7 double split = 60/28/12
    (get_graph.py:210-211)."""
    allowed = _BRCA_TYPES if sep == "\t" else {str(i) for i in range(10)}
    return _filtered_trainval(out_dir, normal_path, typing_path, allowed,
                              sep, (0.6, 0.7), rng)


def camelyon16_trainval(out_dir, rng) -> Split:
    train_list = []
    for type_ in ("tumor", "normal"):
        train_list.extend(
            glob.glob(str(Path(out_dir) / "homogeneous" / (type_ + "*.npz")))
        )
    test_list = sorted(glob.glob(str(Path(out_dir) / "homogeneous" / "test*.npz")))
    test, val = _split(test_list, 0.5)
    return train_list, val, test


def write_split_lists(out_dir, list_name: str, splits: Split) -> None:
    """Write {heterogeneous,homogeneous}_{train,test,val}.txt
    (get_graph.py:337-347): each line points at out_dir/<kind>/<file>."""
    train, val, test = splits
    target = Path(out_dir) / list_name.strip("/")
    target.mkdir(parents=True, exist_ok=True)
    for kind in ("heterogeneous", "homogeneous"):
        for suffix, files in (("_train", train), ("_test", test), ("_val", val)):
            with open(target / f"{kind}{suffix}.txt", "w") as f:
                for p in files:
                    tail = os.path.split(p)[1]
                    f.write(str(Path(out_dir) / kind / tail) + "\n")


def generate_splits(graph_config: Dict, fold: int = 1, seed: int = 0,
                    normal_path: str = "", label_path: str = "") -> str:
    """Dispatch on (dataset, task) like get_graph.py:296-327; returns the
    list directory written."""
    rng = random.Random(seed)
    out_dir = graph_config["out_dir"]
    dataset = graph_config["dataset"]
    task = graph_config.get("task", "cancer classification")

    if dataset == "camelyon16":
        splits = camelyon16_trainval(out_dir, rng)
        list_name = f"/list_f{fold}/"
    elif task == "cancer classification":
        splits = classification_trainval(out_dir, normal_path, rng)
        list_name = f"/list_f{fold}/"
    elif task == "cancer staging":
        splits = staging_trainval(out_dir, normal_path, label_path, rng,
                                  dataset=dataset)
        list_name = f"/list_staging_f{fold}/"
    elif task == "cancer typing":
        sep = "," if dataset == "ESCA" else "\t"
        splits = typing_trainval(out_dir, normal_path, label_path, rng, sep=sep)
        list_name = f"/list_typing_f{fold}/"
    else:
        raise ValueError("No such task")

    print(f"number of training data: {len(splits[0])}")
    print(f"number of val data: {len(splits[1])}")
    print(f"number of test data: {len(splits[2])}")
    write_split_lists(out_dir, list_name, splits)
    return str(Path(out_dir) / list_name.strip("/"))
