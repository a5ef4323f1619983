"""Host ms an epoch in the training loop's per-epoch wait for the card
(the program's ``loop.sync`` spans: ``TrainLoop.run``'s ``_sync``, with
the loss read in ``TrainLoopHR.run``), over the solver-epoch spans of the
profiled sub-window. The program's own records, read in this process
(``benchmark/program_spans.py``): host time under the profiler."""

from benchmark import program_spans as ps


def of(recs):
    return ps.ms_per(recs, ("loop.sync",), ps.EPOCHS)


def read(rec):
    return of(ps.program_records())
