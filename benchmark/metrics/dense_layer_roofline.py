"""Kernels: % of its roofline the bf16 dense-layer kernel (dense_layer_tc)
reaches in the traced request: the frozen bound of the chunks featurized
(58 layers a chunk, roofline.py) over the profiler's summed kernel time."""
SOURCE = "device_trace"


def read(record):
    import roofline
    from common import kernel_seconds

    tr, tc = record.get("trace"), record.get("traced") or {}
    if not tr or not tc.get("chunks"):
        return None
    t = kernel_seconds(tr, "dense_layer_tc")
    if t <= 0:
        return None
    return 100.0 * tc["chunks"] * roofline.dense_layer_chunk_bound_s(tc["chunk"]) / t
