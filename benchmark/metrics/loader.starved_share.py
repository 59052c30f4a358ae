"""Trainer and loader: % of the step loop's fetches from the prefetch
queue that found it empty (the program's counter `loader/starved` over
its `loader/wait` spans) in the traced sub-window."""
SOURCE = "program_counter"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    snap = profiling.GLOBAL_TIMER.snapshot()
    waits = profiling.summed(snap, "loader/wait")
    if not waits:
        return None
    starved = snap["counters"].get("loader/starved", {"total": 0})["total"]
    return 100.0 * starved / waits["count"]
