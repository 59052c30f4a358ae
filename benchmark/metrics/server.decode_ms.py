"""HTTP server: mean ms a request spends reading and decoding its body,
from BatchingServer.stats over the window (decode_ms_sum / requests)."""
SOURCE = "program_counter"


def read(record):
    c = record.get("counters")
    if not c or not c["requests"]:
        return None
    return c["decode_ms_sum"] / c["requests"]
