"""ingest_rows_s (s): the runner's ingest in set-up, its first pass: one sorted
set of item ids a basket (``padded_from_transactions``), the program's span
``repro_torch.ingest.rows`` (``perfbench/spans.py``). Nothing where the
program has no such span."""

from perfbench.spans import seconds_a_call


def read(r):
    return seconds_a_call("repro_torch.ingest.rows")
