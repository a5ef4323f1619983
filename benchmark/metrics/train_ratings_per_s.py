"""The units of work (train ratings or BPR pairs) times the epochs
finished in the window, over the window's wall."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return rec["units_per_epoch"] * rec["epochs"] / rec["window_s"]
