"""ingest_s (s): the runner's ``ingest`` in set-up (``TorchRunner.ingest``:
the one host pass over the baskets), the benchmark's span around the call."""


def read(r):
    return r.spans.get("ingest")
