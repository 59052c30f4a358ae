"""Trainer and loader: % of the window the step loop waits in next() on
the trainer's loader (the benchmark's host clock around each next())."""
SOURCE = "host_clock"


def read(record):
    if "loader_wait_s" not in record or not record.get("window_s"):
        return None
    return 100.0 * record["loader_wait_s"] / record["window_s"]
