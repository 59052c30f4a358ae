"""Whole step: % of the card's f32 peak (67 TF/s; the port trains with
TF32 off) that the forward and backward operations of the real slides
stepped in the traced sub-window would take, over the sub-window."""
SOURCE = "device_trace"


def read(record):
    import roofline

    tr, tc = record.get("trace"), record.get("traced") or {}
    if not tr or not tr["n_device_events"] or not tc.get("sizes"):
        return None
    flops = roofline.train_flops(record["model"], tc["sizes"], record["gnn"])
    return 100.0 * flops / roofline.PEAK_FLOPS["float32"] / tr["window_s"]
