"""Kernels: % of its roofline the KNN kernels (knn_l2_*) reach in the
traced sub-window: N (N + 1) D operations of the real slides served
there, at the f32 peak, over the profiler's summed time of every KNN
launch (the group's padding copies included)."""
SOURCE = "device_trace"


def read(record):
    import roofline
    from common import kernel_seconds

    tr, tc = record.get("trace"), record.get("traced") or {}
    sizes = tc.get("sizes") or tc.get("knn_sizes")
    if not tr or not sizes:
        return None
    t = kernel_seconds(tr, "knn_l2")
    if t <= 0:
        return None
    d = int(record["gnn"]["in_dim"])
    ops = sum(roofline.knn_ops(n, d) for n in sizes)
    return 100.0 * ops / roofline.PEAK_FLOPS["float32"] / t
