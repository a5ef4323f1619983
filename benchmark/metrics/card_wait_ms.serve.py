"""Host ms a request in its copies and waits on the card (the program's
``serve.ids_in``, ``topk.check_ids`` and ``serve.answers_out`` spans),
over the ``serve.request`` spans of the profiled requests. The program's
own records, read in this process (``benchmark/program_spans.py``): host
time under the profiler."""

from benchmark import program_spans as ps

WAITS = ("serve.ids_in", "topk.check_ids", "serve.answers_out")


def of(recs):
    return ps.ms_per(recs, WAITS, ps.REQUESTS)


def read(rec):
    return of(ps.program_records())
