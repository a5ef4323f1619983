"""Least time of the epochs' model work over the device time of the stripe
kernel (csrc/dense_rows.cu: its panel, step and bf16-copy kernels) in
the profiled sub-window, in %. Nothing to read where the kernel did not
run."""

KERNELS = ("panel_kernel", "step_kernel", "u_bf16_kernel")


def read(rec):
    prof = rec.get("prof")
    if not prof or not prof.get("epochs"):
        return None
    us = sum(o["self_device_us"] for o in prof["ops"] if o["on_device"]
             and any(k in o["name"] for k in KERNELS))
    if us <= 0:
        return None
    return 100.0 * rec["least_epoch_s"] * prof["epochs"] / (us / 1e6)
