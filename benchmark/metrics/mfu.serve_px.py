"""Whole step: % of the card's peak the traced pixel request reaches:
the CNNs' operations a patch (bf16, 989 TF/s) and the KNN's and HEAT4's
(f32, 67 TF/s), as seconds at those peaks, over the request's traced
time."""
SOURCE = "device_trace"


def read(record):
    import roofline

    tr, tc = record.get("trace"), record.get("traced") or {}
    if not tr or not tr["n_device_events"] or not tc.get("patches"):
        return None
    d = int(tc["gnn"]["in_dim"])
    f32 = sum(roofline.knn_ops(n, d) + roofline.heat4_forward_flops(n, e, tc["gnn"])
              for n, e in tc["gnn_sizes"])
    at_peak = roofline.seconds_at_peak({
        "bfloat16": roofline.cnn_flops_per_patch() * tc["patches"],
        "float32": f32})
    return 100.0 * at_peak / tr["window_s"]
