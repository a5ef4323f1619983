"""The host's share of a request, in ms: the mean service wall (the call
of Recommender.recommend to its answer in host memory) over the window's
requests, minus the device's busy time a request over the profiled
requests. Every request of a cell has the same number of users, so both
terms are of the same work (the profiled ones are timed apart because
the profiler slows the host)."""


def read(rec):
    prof = rec.get("prof")
    if not rec.get("service_s") or not prof or prof["busy_s"] <= 0:
        return None
    wall = rec["request_wall_s"] / len(rec["service_s"])
    return 1e3 * (wall - prof["busy_s"] / prof["requests"])
