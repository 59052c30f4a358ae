"""Device: % of the traced sub-window of the UNI2-h pixel request in
which no kernel or copy ran on the card (1 - the union of the profiler's
device intervals over the window)."""
SOURCE = "device_trace"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["n_device_events"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
