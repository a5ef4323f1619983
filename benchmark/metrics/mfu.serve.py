"""Least time of the window's scoring work (benchmark/roofline.py) over
the requests' service wall, in %."""


def read(rec):
    if not rec.get("service_s") or rec["request_wall_s"] <= 0:
        return None
    return 100.0 * rec["least_s"] / rec["request_wall_s"]
