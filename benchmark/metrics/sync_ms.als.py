"""Host ms an epoch in the training loop's per-epoch wait for the card
(the program's ``loop.sync`` spans, ``TrainLoop.run``'s ``_sync``), over
the ALS epoch spans (``als.epoch``) of the profiled sub-window. The
program's own records, read in this process
(``benchmark/program_spans.py``): host time under the profiler."""

from benchmark import program_spans as ps


def of(recs):
    return ps.ms_per(recs, ("loop.sync",), ("als.epoch",))


def read(rec):
    return of(ps.program_records())
