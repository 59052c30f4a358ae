"""Whole step: % of the card's bf16 peak (989 TF/s) that the traced
gigapath step reaches: 3 x its forward operations (reference/longnet.py's
hand count at the slide's length: the linear maps and the attention,
padding included) over the traced sub-window."""
SOURCE = "device_trace"


def read(record):
    import roofline

    tr, tc, arch = record.get("trace"), record.get("traced") or {}, record.get("arch")
    if not tr or not tr["n_device_events"] or not tc.get("tokens") or not arch:
        return None
    from reference import longnet

    flops = sum(3.0 * longnet.forward_flops(t, arch) for t in tc["tokens"])
    return 100.0 * flops / roofline.PEAK_FLOPS["bfloat16"] / tr["window_s"]
