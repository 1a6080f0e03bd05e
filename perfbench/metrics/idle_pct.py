"""idle_pct (%): the share of the traced window in which nothing ran on
the device, 100 less the union of its device intervals over its length."""

from perfbench import devtrace


def read(r):
    lo, hi = r.window
    if not r.device_events or hi <= lo:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(r.device_events, lo, hi)
                    / (hi - lo))
