"""launches_per_job (launches): hand-written kernel launches in one job,
the program's own counter (``repro_torch.kernels.support_count.launches``)
read before and after each untraced job of a ``--trace 1`` run.  Nothing
when no kernel ran."""


def read(r):
    if not r.launches or not any(r.launches):
        return None
    return sum(r.launches) / len(r.launches)
