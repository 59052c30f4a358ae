"""Trainer and loader: % of the slides the packer took whose read had
already finished on the loader's read pool (the program's counter
`loader/read_ready` over it and `loader/read_late`) in the traced
sub-window."""
SOURCE = "program_counter"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    counters = profiling.GLOBAL_TIMER.snapshot()["counters"]
    ready, late = (counters.get(f"loader/read_{c}", {"total": 0})["total"]
                   for c in ("ready", "late"))
    return 100.0 * ready / (ready + late) if ready + late else None
