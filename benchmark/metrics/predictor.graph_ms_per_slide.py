"""Request: card ms building a slide's graph (KNN and Pearson signs) in
the traced request (the CUDA events of the program's `predict/graph`
spans over the slides served)."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    slides = len((record.get("traced") or {}).get("gnn_sizes") or ())
    if not (record.get("trace") and slides and hasattr(profiling, "summed")):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "predict/graph")
    if not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / slides
