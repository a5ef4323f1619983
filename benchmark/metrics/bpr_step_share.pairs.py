"""Share of the stream-BPR engine's batches that went through its fused
kernel: the program's ``bpr.step`` counter (one a kernel step call,
``ops/bpr_step.BPRStep``) over its ``bpr.batches`` counter (each solver
epoch's batches, ``solvers/bpr.py``) in the profiled sub-window, read in
this process (``benchmark/program_spans.py``). Nothing to read where the
program counts no batches."""

from benchmark import program_spans as ps


def of(recs):
    if not recs or not recs["counts"].get("bpr.batches"):
        return None
    return recs["counts"].get("bpr.step", 0) / recs["counts"]["bpr.batches"]


def read(rec):
    return of(ps.program_records())
