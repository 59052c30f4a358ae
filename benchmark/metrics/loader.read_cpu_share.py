"""Trainer and loader: % of the `loader/read` spans' wall time that the
prefetch thread spent on a CPU (thread_time over perf_counter) in the
traced sub-window; the rest it waited, on the interpreter lock or on
I/O."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "loader/read")
    return 100.0 * s["cpu_s"] / s["host_s"] if s and s["host_s"] > 0 else None
