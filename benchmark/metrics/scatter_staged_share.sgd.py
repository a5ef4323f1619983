"""Share of the ordered scatter's calls that were given a plan staged by
their caller: the program's ``scatter.staged`` counter over its
``scatter.ordered`` spans (``ops/scatter.index_add_ordered_``) in the
profiled sub-window, read in this process (``benchmark/program_spans.py``).
Nothing to read where the program has no such counter."""

from benchmark import program_spans as ps


def of(recs):
    return ps.count_per(recs, "scatter.staged", ("scatter.ordered",))


def read(rec):
    return of(ps.program_records())
