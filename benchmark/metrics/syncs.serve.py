"""Host waits on the card a request (the program's ``card_syncs``
counter: the two reads of the ids' min and max in the top-N kernel's
check, the two copies of the answers to the host), over the
``serve.request`` spans of the profiled requests; a count. The program's
own records, read in this process (``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps


def of(recs):
    return ps.count_per(recs, "card_syncs", ps.REQUESTS)


def read(rec):
    return of(ps.program_records())
