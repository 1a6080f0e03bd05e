"""place_s (s): the runner's ``job1`` and ``place`` in set-up (the device
histogram, the dense re-encode, the encoded-dataset cache and the copy to
the device), the benchmark's span around both calls."""


def read(r):
    return r.spans.get("place")
