"""Serve a trained slide-graph model over HTTP with micro-batching
(counterpart of tools/serve.py):

  python -m wsi_hgnn_tpu_torch.tools.serve -config configs/BRCA/HEAT4_kimia_classification.yml \\
      --port 8080 --radius 9 --warmup 2048
  python -m wsi_hgnn_tpu_torch.tools.serve -config ... --device cpu   # no card

Requests: POST /predict with an .npz body holding `features` [N, D] f32
(+ `node_types` [N] int, the per-slide arrays graph construction writes),
answered with JSON {"probs": [...], "pred": k, "latency_ms": t}; GET
/healthz and GET /stats. `--pixels-config <GraphConstruction YAML>` also
serves raw patch pixels (`pixels` [N, 256, 256, 3] uint8) through the
encoder that YAML's `encoder_name` names ('kimia' when it names none;
HoVer-Net typing beside it for a heterogeneous model), with the weights
it names where those files exist. Runs on the card unless `--device
cpu`; without a card it raises.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-config", required=True,
                   help="training YAML (GNN + checkpoint sections)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--radius", type=int, default=9,
                   help="KNN radius of the construction operating point")
    p.add_argument("--n-node-types", type=int, default=6)
    p.add_argument("--knn-impl", default="exact",
                   choices=["exact", "approx", "pallas"])
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--warmup", type=int, default=0,
                   help="run this many patches per slide once before "
                        "serving (0 = off)")
    p.add_argument("--lattice-mem-budget", type=int, default=2 << 30,
                   help="bytes allowed for the lattice path's [B, N*k, N] "
                        "one-hot working set; larger groups take the "
                        "TypedGraph path")
    p.add_argument("--pixels-config", default="",
                   help="GraphConstruction YAML (graph_constructor/"
                        "hovernet_config/kimianet_config sections); enables "
                        "POST `pixels` requests through its encoder")
    p.add_argument("--max-body-mb", type=float, default=512.0,
                   help="request body cap (a 2048-patch uint8 pixel slide "
                        "is ~402 MB)")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..serve import BatchingServer, SlidePredictor

    config = load_config(args.config)
    predictor = SlidePredictor(
        config, radius=args.radius, n_node_types=args.n_node_types,
        knn_impl=args.knn_impl, lattice_mem_budget=args.lattice_mem_budget,
        device=args.device)
    if args.pixels_config:
        enable_pixels_from(predictor, load_config(args.pixels_config))
    if args.warmup:
        # before the socket is bound, so clients see a refused connection,
        # not a hung one, while the kernels build; at max_batch, the batch
        # the server pads every group to
        print(f"warmup: batch {args.max_batch} x {args.warmup}-patch slides")
        warm = (predictor.warmup_pixels if predictor.pixels_enabled
                else predictor.warmup)
        warm(args.warmup, batch_sizes=(args.max_batch,))
    server = BatchingServer(
        predictor, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_body_mb=args.max_body_mb)
    print(f"serving model v{predictor.version} on {predictor.device} at "
          f"http://{args.host}:{server.port}  (POST /predict"
          + (", pixels enabled)" if predictor.pixels_enabled else ")"),
          flush=True)
    server.serve_forever()


def enable_pixels_from(predictor, gcfg) -> None:
    """Attach the encoder a GraphConstruction config names to `predictor`:
    `graph_constructor.encoder_name` ('kimia' where it names none), with
    its weight paths, and HoVer-Net typing beside it for a heterogeneous
    model. An encoder the port does not build (e.g. 'efficientnet-b7')
    raises NotImplementedError before anything is served."""
    gc = gcfg.get("graph_constructor") or {}
    predictor.enable_pixels(
        gcfg.get("hovernet_config") or {},
        gcfg.get("kimianet_config") or {},
        encoder_name=gc.get("encoder_name") or "kimia",
        encoder_config={k: gc[k] for k in ("efficientnet_model_path",
                                           "uni2h_model_path")
                        if gc.get(k)})


if __name__ == "__main__":
    main()
