"""Least time of the profiled requests' scoring work over the device time
of the fused top-N kernels (csrc/topk.cu: the fused pass and its merge),
in %. Nothing to read where they did not run."""

KERNELS = ("topk_fused_kernel", "topk_merge_kernel")


def read(rec):
    prof = rec.get("prof")
    if not prof or "least_s" not in prof:
        return None
    us = sum(o["self_device_us"] for o in prof["ops"] if o["on_device"]
             and any(k in o["name"] for k in KERNELS))
    if us <= 0:
        return None
    return 100.0 * prof["least_s"] / (us / 1e6)
