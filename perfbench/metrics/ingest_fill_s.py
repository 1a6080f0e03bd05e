"""ingest_fill_s (s): the runner's ingest in set-up, its second pass: the
(N, L) padded matrix filled row by row, the program's span
``repro_torch.ingest.fill`` (``perfbench/spans.py``). Nothing where the
program has no such span."""

from perfbench.spans import seconds_a_call


def read(r):
    return seconds_a_call("repro_torch.ingest.fill")
