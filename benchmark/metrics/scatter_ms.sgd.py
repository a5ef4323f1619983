"""Device ms an epoch of the kernels under aten::index_put_ (the ordered
scatter on the card), from the profiled sub-window."""


def read(rec):
    prof = rec.get("prof")
    if not prof or not prof.get("epochs"):
        return None
    us = sum(o["device_total_us"] for o in prof["ops"]
             if o["name"] == "aten::index_put_" and not o["on_device"])
    return us / 1e3 / prof["epochs"] if us > 0 else None
