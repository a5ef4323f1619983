"""1 - the device's busy time over the profiled sub-window's wall, in %."""


def read(rec):
    prof = rec.get("prof")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
