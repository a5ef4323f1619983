"""Share of the bucketed ALS layout's gathered slots that hold a rating,
in %: the program's ``als.ratings`` counter over its ``als.slots``
counter (each chunk's rated slots and nb x cap, ``solvers/als.py``) in
the profiled sub-window, read in this process
(``benchmark/program_spans.py``). Nothing to read where the program
counts no slots."""

from benchmark import program_spans as ps


def of(recs):
    if not recs or not recs["counts"].get("als.slots"):
        return None
    return 100.0 * recs["counts"].get("als.ratings", 0) / \
        recs["counts"]["als.slots"]


def read(rec):
    return of(ps.program_records())
