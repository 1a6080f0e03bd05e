"""device_busy_s (s): seconds a job in which some operation ran on the
device, the union of the traced jobs' device intervals (kernels, copies,
fills) over the number of traced jobs."""

from perfbench import devtrace


def read(r):
    if not r.device_events or not r.traced_jobs:
        return None
    lo, hi = r.window
    return devtrace.busy_seconds(r.device_events, lo, hi) / r.traced_jobs
