"""Request: mean ms of a warm SlidePredictor.predict_many call under the
server (timing device_ms / warm calls over the window: a host clock
around device work that ends in a copy to the host)."""
SOURCE = "program_span"


def read(record):
    t = record.get("timing")
    if not t:
        return None
    warm = t["calls"] - t["cold_calls"]
    return t["device_ms"] / warm if warm > 0 else None
