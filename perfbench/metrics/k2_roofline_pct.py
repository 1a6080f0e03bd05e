"""k2_roofline_pct (%): kernel 2 (``support_count``) at its roofline: the
least time the traced jobs' counts could take on the card (2 N C F int8
operations over the job's F frequent items, or byte rows, k-hot
candidates, kvec and counts read once; ``roofline.py``) over the kernel's
device time in the trace."""

from perfbench import roofline

KERNEL = "support_count_kernel"
OTHER = "packed_support_count_kernel"


def read(r):
    busy = sum(e - s for name, s, e in r.device_events
               if KERNEL in name and OTHER not in name)
    if busy <= 0 or not r.traced_jobs:
        return None
    bound = roofline.bitmap_count_bound_s(r.shape["rows"], r.shape["cands"],
                                          r.shape["items"])
    return 100.0 * bound * r.traced_jobs / busy
