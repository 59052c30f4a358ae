"""Request: mean card ms between two chunks of the traced request (the
program's counter `featurize/chunk_gap_ns`: CUDA events from the end of a
chunk's last CNN stage to the start of the next chunk's first, over the
gaps counted)."""
SOURCE = "program_counter"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    counters = profiling.GLOBAL_TIMER.snapshot()["counters"]
    c = counters.get("featurize/chunk_gap_ns")
    return c["total"] * 1e-6 / c["calls"] if c and c["calls"] else None
