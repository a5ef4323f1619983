"""Least time of the epochs' model work (benchmark/roofline.py) over the
window's wall, checks included, in %."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * rec["least_epoch_s"] * rec["epochs"] / rec["window_s"]
