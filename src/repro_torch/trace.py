"""Host spans of the port: the one place that names where its host time
goes.

``with span("repro_torch.engine.launch"): ...`` adds the block's
``perf_counter`` seconds and one call to the process-wide totals under its
name, for one to two microseconds.  While a profiler records
(``torch.autograd._profiler_enabled()``), the span also enters
``torch.profiler.record_function(name)``, so it lies on the profiler's
clock beside the device's events and a trace can name the idle gaps
inside it.  There is no switch: the totals are always kept, and the
profiler's range is entered exactly when a profiler records.

A span wraps one phase or one chunk of work, never one row block: while a
profiler records, each range costs some microseconds.  ``totals()`` is a
snapshot, ``reset()`` clears the totals (tests).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import torch

_lock = threading.Lock()
_seconds: Dict[str, float] = {}
_calls: Dict[str, int] = {}


class span:
    """Context manager: time the block under ``name`` (see the module)."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            _seconds[self.name] = _seconds.get(self.name, 0.0) + dt
            _calls[self.name] = _calls.get(self.name, 0) + 1


def totals() -> Dict[str, Dict]:
    """``{"seconds": {name: s}, "calls": {name: n}}`` of every span so far."""
    with _lock:
        return {"seconds": dict(_seconds), "calls": dict(_calls)}


def reset() -> None:
    with _lock:
        _seconds.clear()
        _calls.clear()
