"""Whole step: % of the card's f32 peak (67 TF/s) that the KNN and
HEAT4 forward of the real slides served in the traced sub-window would
take, over the sub-window."""
SOURCE = "device_trace"


def read(record):
    import roofline

    tr, tc = record.get("trace"), record.get("traced") or {}
    sizes = tc.get("sizes")
    if not tr or not tr["n_device_events"] or not sizes:
        return None
    gnn = record["gnn"]
    k = int(record["radius"]) - 1
    d = int(gnn["in_dim"])
    f32 = sum(roofline.knn_ops(n, d) + roofline.heat4_forward_flops(n, n * k, gnn)
              for n in sizes)
    return 100.0 * f32 / roofline.PEAK_FLOPS["float32"] / tr["window_s"]
