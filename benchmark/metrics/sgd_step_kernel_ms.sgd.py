"""Device ms an epoch of the gradient kernel of the sgd engine's fused
batch step (``csrc/sgd_step.cu``'s ``sgd_grad_kernel``, found by its name)
in the profiled sub-window. Nothing to read where the kernel did not
run."""

KERNEL = "sgd_grad_kernel"


def read(rec):
    prof = rec.get("prof")
    if not prof or not prof.get("epochs"):
        return None
    us = sum(o["self_device_us"] for o in prof["ops"] if o["on_device"]
             and KERNEL in o["name"])
    return us / 1e3 / prof["epochs"] if us > 0 else None
