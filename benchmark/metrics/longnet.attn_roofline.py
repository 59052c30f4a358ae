"""Kernels: % of its roofline LongNet's dilated attention reaches in the
traced step: the forward attention operations of every layer at the
traced slide's length, padding included (reference/longnet.py's hand
count; bf16, so the bound is operations at 989 TF/s), over the card time
of the program's `longnet/attn` spans (CUDA events: the regrouping, the
five attentions and the merge of each layer's forward)."""
SOURCE = "program_span"


def read(record):
    import roofline
    from wsi_hgnn_tpu_torch import profiling

    tc, arch = record.get("traced") or {}, record.get("arch")
    if not (record.get("trace") and tc.get("tokens") and arch
            and hasattr(profiling, "summed")):
        return None
    from reference import longnet

    s = profiling.summed(profiling.GLOBAL_TIMER.snapshot(), "longnet/attn")
    if not s or not s["device_s"]:
        return None
    flops = sum(arch["depth"] * longnet.attention_flops(t, arch)
                for t in tc["tokens"])
    return 100.0 * roofline.bound_s(0.0, flops, "bfloat16") / s["device_s"]
