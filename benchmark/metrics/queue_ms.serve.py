"""Mean ms a request waits from its arrival until the client calls
Recommender.recommend (behind the request before it), over the window."""


def read(rec):
    lat, svc = rec.get("latencies_s"), rec.get("service_s")
    if not lat:
        return None
    return 1e3 * (sum(lat) - sum(svc)) / len(lat)
