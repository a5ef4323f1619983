"""Host ms from the call of solver.epoch to its return, before the loop
synchronizes: the host's cost of an epoch (mean over the window)."""


def read(rec):
    if not rec.get("enqueue_s"):
        return None
    return 1e3 * sum(rec["enqueue_s"]) / len(rec["enqueue_s"])
