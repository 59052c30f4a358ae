"""Convert the reference's pickled DGL slide graphs to the `.npz` graphs
both packages read (counterpart of tools/convert_reference_graphs.py;
`convert_hetero` and `convert_homo` are copies, written through the
port's `save_graph_npz`):

    python -m wsi_hgnn_tpu_torch.tools.convert_reference_graphs \
        --in-dir data/BRCA_kimia_lv0 --out-dir data/BRCA_kimia_lv0_npz

The reference stores one pickled DGL graph per slide: heterogeneous
graphs from `dgl.to_heterogeneous` with 6 PanNuke node types x {neg, pos}
edge types and 'feat'/'sim' data, and homogeneous twins. Unpickling them
needs the `dgl` package, which neither package depends on: run the tool
where `dgl` imports. The conversion itself reads only the graph objects'
DGL-style accessors.
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import sys

import numpy as np

from ..data.datasets import save_graph_npz


def convert_hetero(g) -> dict:
    """DGL heterograph -> flat arrays (node order: type-major, matching
    dgl.to_homogeneous so `sim`/edge order survive the round trip)."""
    ntypes = sorted(g.ntypes, key=int)
    offsets, feats, types = {}, [], []
    off = 0
    for nt in ntypes:
        n = g.num_nodes(nt)
        offsets[nt] = off
        if n:
            feats.append(g.nodes[nt].data["feat"].numpy())
            types.append(np.full(n, int(nt), np.int32))
        off += n
    feat = np.concatenate(feats) if feats else np.zeros((0, 1024), np.float32)
    node_type = np.concatenate(types) if types else np.zeros(0, np.int32)

    srcs, dsts, esigns, sims = [], [], [], []
    for (s, e, d) in g.canonical_etypes:
        u, v = g.edges(etype=(s, e, d))
        if len(u) == 0:
            continue
        srcs.append(u.numpy().astype(np.int64) + offsets[s])
        dsts.append(v.numpy().astype(np.int64) + offsets[d])
        esigns.append(np.full(len(u), 1 if e == "pos" else 0, np.int32))
        ed = g.edges[(s, e, d)].data
        sims.append(
            ed["sim"].numpy().astype(np.float32)
            if "sim" in ed else np.ones(len(u), np.float32)
        )
    return dict(
        feat=feat.astype(np.float32),
        src=np.concatenate(srcs) if srcs else np.zeros(0, np.int64),
        dst=np.concatenate(dsts) if dsts else np.zeros(0, np.int64),
        node_type=node_type,
        esign=np.concatenate(esigns) if esigns else np.zeros(0, np.int32),
        sim=np.concatenate(sims) if sims else np.zeros(0, np.float32),
        is_hetero=True,
    )


def convert_homo(g) -> dict:
    """DGL homogeneous graph -> flat arrays (`_TYPE` edge data as the
    sign, `sim` where present)."""
    u, v = g.edges()
    ed = g.edata
    e = len(u.numpy())
    return dict(
        feat=g.ndata["feat"].numpy().astype(np.float32),
        src=u.numpy().astype(np.int64),
        dst=v.numpy().astype(np.int64),
        node_type=None,
        esign=(ed["_TYPE"].numpy().astype(np.int32) if "_TYPE" in ed
               else np.ones(e, np.int32)),
        sim=(ed["sim"].numpy().astype(np.float32) if "sim" in ed
             else np.ones(e, np.float32)),
        is_hetero=False,
    )


def convert_dir(in_dir: str, out_dir: str, load=pickle.load) -> int:
    """Every `<in_dir>/{heterogeneous,homogeneous}/*.pkl` written as
    `<out_dir>/<kind>/<name>.npz`; returns the number of graphs."""
    n = 0
    for kind, conv in (("heterogeneous", convert_hetero),
                       ("homogeneous", convert_homo)):
        out = os.path.join(out_dir, kind)
        os.makedirs(out, exist_ok=True)
        for p in sorted(glob.glob(os.path.join(in_dir, kind, "*.pkl"))):
            with open(p, "rb") as f:
                g = load(f)
            name = os.path.basename(p)[:-4]
            save_graph_npz(os.path.join(out, name + ".npz"), **conv(g))
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in-dir", required=True,
                    help="reference out_dir with heterogeneous/ homogeneous/ "
                         "pkls")
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    try:
        import dgl  # noqa: F401
    except ImportError:
        sys.exit("this converter needs the `dgl` package to unpickle "
                 "reference graphs; run it in the reference's environment")
    n = convert_dir(args.in_dir, args.out_dir)
    print(f"converted {n} graphs into {args.out_dir}")


if __name__ == "__main__":
    main()
