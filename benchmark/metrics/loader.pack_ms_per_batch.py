"""Trainer and loader: mean ms the prefetch thread spends packing one
batch (the program's `loader/pack` span: batch_graphs + sort_graph_edges,
or pack_slide + stack) in the traced sub-window."""
SOURCE = "program_span"


def read(record):
    from wsi_hgnn_tpu_torch import profiling

    if not record.get("trace") or not hasattr(profiling, "summed"):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "loader/pack")
    return 1e3 * s["host_s"] / s["count"] if s else None
