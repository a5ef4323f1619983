"""Share of the sgd engine's batches that went through its fused kernel:
the program's ``sgd.step`` counter (one a kernel call,
``ops/sgd_step.SGDStep``) over its ``sgd.batches`` counter (each solver
epoch's batches, ``solvers/sgd.py``) in the profiled sub-window, read in
this process (``benchmark/program_spans.py``). Nothing to read where the
program counts no batches."""

from benchmark import program_spans as ps


def of(recs):
    if not recs or not recs["counts"].get("sgd.batches"):
        return None
    return recs["counts"].get("sgd.step", 0) / recs["counts"]["sgd.batches"]


def read(rec):
    return of(ps.program_records())
