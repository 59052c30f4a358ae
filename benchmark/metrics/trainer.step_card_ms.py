"""Trainer and loader: mean card ms of one GNNTrainer.train_step (the CUDA
events of the program's `train/step` span: from the card reaching the
step's first operation to its last) in the traced sub-window."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "train/step")
    if not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / s["count"]
