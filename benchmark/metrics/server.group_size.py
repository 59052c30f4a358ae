"""HTTP server: requests per device call (stats requests / batches over
the window); pad_batches pads every call to max_batch, so this is the
share of a call's slides that are real, times max_batch."""
SOURCE = "program_counter"


def read(record):
    c = record.get("counters")
    if not c or not c["batches"]:
        return None
    return c["requests"] / c["batches"]
