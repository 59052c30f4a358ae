"""Trainer and loader: mean ms the loader's prefetch thread spends reading
one slide (the program's `loader/read` span around each dataset[i]: the
.npz's np.load and inflate) in the traced sub-window."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "loader/read")
    return 1e3 * s["host_s"] / s["count"] if s else None
