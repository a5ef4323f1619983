"""Host ms an epoch in the ordered scatter (the program's
``scatter.ordered`` spans: ``ops/scatter.index_add_ordered_``, whose card
route is ``index_put_(accumulate=True)``), over the solver-epoch spans of
the profiled sub-window. The program's own records, read in this process
(``benchmark/program_spans.py``): host time under the profiler."""

from benchmark import program_spans as ps


def of(recs):
    return ps.ms_per(recs, ("scatter.ordered",), ps.EPOCHS)


def read(rec):
    return of(ps.program_records())
