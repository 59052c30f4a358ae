"""Kernels: % of its roofline the UNI2-h ViT reaches in the traced
request: the frozen operations of the chunks run, padding included
(reference/vit.py's FLOPS_PER_PATCH a patch: every product is bf16, so
the bound is operations at 989 TF/s), over the card time of the
program's `encode/vit` spans (CUDA events; the resize and normalisation
inside them)."""
SOURCE = "program_span"


def read(record):
    import roofline
    from wsi_hgnn_tpu_torch import profiling

    tc = record.get("traced") or {}
    if not (record.get("trace") and tc.get("chunks") and tc.get("flops_per_patch")
            and hasattr(profiling, "summed")):
        return None
    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "encode/vit")
    if not s or not s["device_s"]:
        return None
    flops = tc["chunks"] * tc["chunk"] * tc["flops_per_patch"]
    return 100.0 * roofline.bound_s(0.0, flops, "bfloat16") / s["device_s"]
