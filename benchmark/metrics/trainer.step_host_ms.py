"""Trainer and loader: mean host ms of one GNNTrainer.train_step (the
program's `train/step` span: the time the host takes to issue the step)
in the traced sub-window."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "train/step")
    return 1e3 * s["host_s"] / s["count"] if s else None
