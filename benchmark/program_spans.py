"""The program's own spans and counters, read in this process after a
traced run through ``matfac_tpu_torch.train.profiler.records()``.

The program keeps a span or a count only while a ``torch.profiler``
records, and a run records only its profiled sub-window, so the records
are that sub-window's: their milliseconds are host time under the
profiler (``time.perf_counter_ns`` inside each span). A program without
``records`` (one older than its spans), or one that kept nothing of a
formula's spans, gives None, and the metric is left out."""

from __future__ import annotations

from typing import Optional, Sequence

# the solvers' epoch spans: the unit a training formula divides by
EPOCHS = ("sgd.epoch", "bpr.epoch", "stripes.epoch")
REQUESTS = ("serve.request",)


def program_records() -> Optional[dict]:
    """``records()`` of the program: ``spans`` (tuples of name, parent,
    t0_ns, t1_ns, req) and ``counts``; None without the function."""
    from matfac_tpu_torch.train import profiler
    records = getattr(profiler, "records", None)
    return records() if records is not None else None


def kept(recs: dict, names: Sequence[str]) -> int:
    return sum(1 for s in recs["spans"] if s[0] in names)


def ms_per(recs: Optional[dict], names: Sequence[str],
           per: Sequence[str]) -> Optional[float]:
    """Host ms in the spans ``names`` over the count of the spans
    ``per``; None where either was not kept."""
    if not recs:
        return None
    n = kept(recs, per)
    if not n or not kept(recs, names):
        return None
    ns = sum(s[3] - s[2] for s in recs["spans"] if s[0] in names)
    return ns / 1e6 / n


def count_per(recs: Optional[dict], counter: str,
              per: Sequence[str]) -> Optional[float]:
    """The counter ``counter`` over the count of the spans ``per``; None
    where either was not kept."""
    if not recs or counter not in recs["counts"]:
        return None
    n = kept(recs, per)
    return recs["counts"][counter] / n if n else None
