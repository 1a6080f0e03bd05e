"""The program's own host spans (``repro_torch.trace`` in the port), as
the per-layer readers read them.

The runner's ``ingest``, ``job1`` and ``place`` run once a run, in set-up,
and no count job enters their spans, so a set-up span's seconds a call,
read when the run ends, is its time in set-up.  A program without the
span (or without ``repro_torch.trace``) gives nothing, and no error.
"""

from __future__ import annotations

import importlib
from typing import Optional


def seconds_a_call(name: str) -> Optional[float]:
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return None
    got = trace.totals()
    calls = got["calls"].get(name, 0)
    if not calls:
        return None
    return got["seconds"][name] / calls
