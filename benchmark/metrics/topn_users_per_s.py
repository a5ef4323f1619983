"""Users answered in the window over the window's wall."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return rec["users"] / rec["window_s"]
