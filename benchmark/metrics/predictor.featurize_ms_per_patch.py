"""Request: ms SlidePredictor.featurize spends a patch (timing
featurize_ms over the window's patches; it ends in a copy to the host)."""
SOURCE = "program_span"


def read(record):
    t = record.get("timing")
    if not t or not record.get("patches"):
        return None
    return t["featurize_ms"] / record["patches"]
