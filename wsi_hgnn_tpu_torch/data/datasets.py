"""Slide-graph datasets with the reference's label semantics (counterpart
of wsi_hgnn_tpu/data/datasets.py).

Storage: one `.npz` per slide, keys feat [N, D] f32, src/dst [E] i32,
node_type [N] i32, esign [E] i32, sim [E] f32, and scalars n_node_types,
is_hetero; the JAX package reads and writes the same files. Homogeneous
loads get self-loops appended; heterogeneous ones do not.

Label extraction matches the reference byte for byte:
  * classification: TCGA barcode slice s[pos:pos+16] against a normal-list
    file;
  * staging: s[pos:pos+12] -> 'Stage I..IV' table, tab-separated;
  * typing: ESCA comma-separated int labels, BRCA ductal/lobular;
  * Camelyon16 explanation: the tumour slides of a list, each with its
    annotation XML.
"""
from __future__ import annotations

import io
import os
import zipfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..graph.typed_graph import TypedGraph, from_arrays

_STAGE_MAP = {
    "Stage I": 0, "Stage IA": 0, "Stage IB": 0,
    "Stage IIA": 1, "Stage IIB": 1, "Stage II": 1, "Stage IIC": 1,
    "Stage IIIB": 2, "Stage IIIC": 2, "Stage III": 2, "Stage IIIA": 2,
    "Stage IV": 3, "Stage IVA": 3, "Stage IVB": 3,
}


def save_graph_npz(
    path,
    feat: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    node_type: Optional[np.ndarray] = None,
    esign: Optional[np.ndarray] = None,
    sim: Optional[np.ndarray] = None,
    n_node_types: int = 6,
    is_hetero: bool = True,
) -> None:
    n, e = feat.shape[0], len(src)
    np.savez_compressed(
        path,
        feat=feat.astype(np.float32),
        src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32),
        node_type=(np.zeros(n, np.int32) if node_type is None
                   else np.asarray(node_type, np.int32)),
        esign=(np.ones(e, np.int32) if esign is None
               else np.asarray(esign, np.int32)),
        sim=(np.ones(e, np.float32) if sim is None
             else np.asarray(sim, np.float32)),
        n_node_types=np.int32(n_node_types),
        is_hetero=np.bool_(is_hetero),
    )


def _npy_from_bytes(data: bytes) -> np.ndarray:
    """The array of one whole `.npy` file's bytes, as np.load gives it
    (no pickled objects). The array is a read-only view of `data`."""
    f = io.BytesIO(data)
    version = np.lib.format.read_magic(f)
    if version in ((1, 0), (2, 0)):
        header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                  else np.lib.format.read_array_header_2_0)
        shape, fortran_order, dtype = header(f)
        if not dtype.hasobject:
            count = int(np.prod(shape, dtype=np.int64))
            arr = np.frombuffer(data, dtype, count=count, offset=f.tell())
            if fortran_order:
                return arr.reshape(shape[::-1]).transpose()
            return arr.reshape(shape)
    # the rarer layouts (a 3.0 header, an object array): numpy's own reader
    return np.lib.format.read_array(io.BytesIO(data), allow_pickle=False)


def load_graph_npz(path) -> TypedGraph:
    """A slide's TypedGraph from its `.npz` (any that np.savez or
    np.savez_compressed writes). Each member is inflated in one read:
    np.load's 256 KiB pieces would take the interpreter lock back once a
    piece, which costs a loader's read threads most under a busy step
    loop."""
    with zipfile.ZipFile(path) as zf:
        def z(key):
            return _npy_from_bytes(zf.read(key + ".npy"))

        is_hetero = bool(z("is_hetero"))
        return from_arrays(
            z("feat"), z("src"), z("dst"),
            node_type=z("node_type") if is_hetero else None,
            esign=z("esign"), sim=z("sim"),
            n_node_types=int(z("n_node_types")) if is_hetero else 1,
            add_self_loops=not is_hetero,
        )


def _read_list(path) -> List[str]:
    with open(path) as f:
        return [l.strip() for l in f.readlines() if l.strip()]


def _tcga_pos(s: str) -> int:
    pos = s.find("TCGA")
    if pos < 0:
        raise ValueError(f"no TCGA barcode in path {s!r}")
    return pos


class WSIData:
    """Recursive .svs/.tif slide lister (the reference's WSIData)."""

    def __init__(self, data_root):
        import glob as _glob

        self.data_root = str(data_root)
        self.data_list = []
        for type_ in ("*.svs", "*.tif"):
            self.data_list.extend(
                _glob.glob(self.data_root + "/**/" + type_, recursive=True))

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index):
        return self.data_list[index]


class GraphDataset:
    """Cancer classification: tumor (1) vs normal (0) by barcode list."""

    def __init__(self, graph_path, normal_path, name_, type_):
        self.graph_paths = _read_list(graph_path)
        self.type_ = type_
        self.name_ = name_
        self.normal_list = _read_list(normal_path) if normal_path else []

    def __len__(self):
        return len(self.graph_paths)

    def label_of(self, index: int) -> int:
        s = str(self.graph_paths[index])
        pos = _tcga_pos(s)
        return 0 if s[pos:pos + 16] in self.normal_list else 1

    def __getitem__(self, index) -> Tuple[TypedGraph, int]:
        return load_graph_npz(self.graph_paths[index]), self.label_of(index)


class TCGACancerStageDataset:
    """4-class staging from a tab-separated case -> stage table."""

    def __init__(self, graph_path, label_path, type_):
        self.graph_paths = _read_list(graph_path)
        self.type_ = type_
        mapping = [l.split(sep="\t") for l in _read_list(label_path)]
        self.mapping = {k: v for k, v in mapping}

    def __len__(self):
        return len(self.graph_paths)

    def label_of(self, index: int) -> int:
        s = str(self.graph_paths[index])
        pos = _tcga_pos(s)
        lb = self.mapping[s[pos:pos + 12]]
        if lb not in _STAGE_MAP:
            raise ValueError("Undefined label")
        return _STAGE_MAP[lb]

    def __getitem__(self, index):
        return load_graph_npz(self.graph_paths[index]), self.label_of(index)


class TCGACancerTypingDataset:
    """Cancer typing: ESCA int labels (comma-separated table) or BRCA
    ductal (0) / lobular (1)."""

    def __init__(self, graph_path, label_path, type_):
        self.graph_paths = _read_list(graph_path)
        self.type_ = type_
        self.label_path = str(label_path)
        sep = "," if "ESCA" in self.label_path else "\t"
        mapping = [l.split(sep=sep) for l in _read_list(label_path)]
        self.mapping = {k: v for k, v in mapping}

    def __len__(self):
        return len(self.graph_paths)

    def label_of(self, index: int) -> int:
        s = str(self.graph_paths[index])
        pos = _tcga_pos(s)
        lb = self.mapping[s[pos:pos + 12]]
        if "ESCA" in self.label_path:
            return int(lb)
        if lb == "Infiltrating Ductal Carcinoma":
            return 0
        if lb == "Infiltrating Lobular Carcinoma":
            return 1
        raise ValueError("Undefined label")

    def __getitem__(self, index):
        return load_graph_npz(self.graph_paths[index]), self.label_of(index)


class C16EvalDataset:
    """Camelyon16 explanation eval: the list's tumour slides (label 1
    unless `reference_csv`, a NAME,LABEL table, says Normal), each paired
    with `<annot_path>/<name>.xml`."""

    def __init__(self, graph_path, annot_path, reference_csv):
        import csv

        labels = {}
        with open(reference_csv) as f:
            for row in csv.DictReader(f):
                labels[row["NAME"]] = row["LABEL"]
        self.graph_paths, self.labels, self.xml_paths = [], [], []
        for a in _read_list(graph_path):
            name = os.path.split(a)[1][:-4]
            label = 0 if labels.get(name) == "Normal" else 1
            if label == 1:
                self.graph_paths.append(a)
                self.labels.append(label)
                self.xml_paths.append(str(Path(annot_path) / (name + ".xml")))

    def __len__(self):
        return len(self.graph_paths)

    def __getitem__(self, index):
        return (load_graph_npz(self.graph_paths[index]),
                self.xml_paths[index], self.labels[index])
