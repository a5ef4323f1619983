"""Host ms of one check of the loop (Evaluator.objective and the val
RMSE, or the val HR@10), synchronized around each call, over the
window's checks."""


def read(rec):
    ev = rec.get("check_s", ())
    n = sum(1 for kind, _ in ev if kind in ("rmse", "hr10"))
    return 1e3 * sum(s for _, s in ev) / n if n else None
