"""Request: card ms the UNI2-h ViT takes a patch in the traced request
(the CUDA events of the program's `encode/vit` spans, one a chunk, the
resize and normalisation included, over the request's patches)."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    patches = (record.get("traced") or {}).get("patches")
    if not (record.get("trace") and patches and hasattr(profiling, "summed")):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "encode/vit")
    if not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / patches
