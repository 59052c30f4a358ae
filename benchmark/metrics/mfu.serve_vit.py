"""Whole step: % of the card's peak the traced pixel request reaches:
the ViT's operations on the request's patches (bf16, 989 TF/s) and the
KNN's and GAT's (f32, 67 TF/s), as seconds at those peaks, over the
request's traced time."""
SOURCE = "device_trace"


def read(record):
    import roofline
    from reference import gat

    tr, tc = record.get("trace"), record.get("traced") or {}
    if not tr or not tr["n_device_events"] or not tc.get("flops_per_patch"):
        return None
    d = int(tc["gnn"]["in_dim"])
    f32 = sum(roofline.knn_ops(n, d) + gat.forward_flops(n, e, tc["gnn"])
              for n, e in tc["gnn_sizes"])
    at_peak = roofline.seconds_at_peak({
        "bfloat16": tc["flops_per_patch"] * tc["patches"], "float32": f32})
    return 100.0 * at_peak / tr["window_s"]
