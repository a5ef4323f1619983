"""Host ms an epoch in the stripe engine's rank draw and its checks (the
program's ``stripes.ranks`` spans: ``BlockSGDSolver.epoch_ranks`` and, in
``ops/dense_row_kernel.dense_rows_epoch``, the rank checks and the rank
rows put in stripe order), over the solver-epoch spans of the profiled
sub-window. The program's own records, read in this process
(``benchmark/program_spans.py``): host time under the profiler."""

from benchmark import program_spans as ps


def of(recs):
    return ps.ms_per(recs, ("stripes.ranks",), ps.EPOCHS)


def read(rec):
    return of(ps.program_records())
