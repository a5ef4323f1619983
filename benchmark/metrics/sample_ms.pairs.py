"""Host ms an epoch in the BPR sampler's draws (the program's
``bpr.sample`` spans, one a batch), over the ``bpr.epoch`` spans of the
profiled sub-window. The program's own records, read in this process
(``benchmark/program_spans.py``): host time under the profiler."""

from benchmark import program_spans as ps


def of(recs):
    return ps.ms_per(recs, ("bpr.sample",), ("bpr.epoch",))


def read(rec):
    return of(ps.program_records())
