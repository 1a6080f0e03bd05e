"""dispatch_s (s): the engine's dispatch of one job, the mean over the
untraced jobs of a ``--trace 1`` run of ``JobProfile.encode_seconds``: the
host time of ``count_candidates_async`` (candidate pad and encode, one
launch per row block and chunk, and the waits on results that the queue's
depth forces)."""


def read(r):
    if not r.encode_seconds:
        return None
    return sum(r.encode_seconds) / len(r.encode_seconds)
