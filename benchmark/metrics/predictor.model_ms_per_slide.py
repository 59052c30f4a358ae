"""Request: card ms of HEAT4's forward and softmax on a slide in the
traced request (the CUDA events of the program's `predict/model` spans
over the slides served)."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    slides = len((record.get("traced") or {}).get("gnn_sizes") or ())
    if not (record.get("trace") and slides and hasattr(profiling, "summed")):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "predict/model")
    if not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / slides
