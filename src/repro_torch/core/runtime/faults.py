"""Deterministic fault injection + task-recovery policy for the runtime.

The paper's platform is Hadoop, and half of what MapReduce buys is not
speed but *survival*: failed tasks are retried, stragglers are speculatively
re-executed, and jobs restart from durable state.  This module is the one
place that vocabulary lives:

``FaultSpec`` / ``FaultPlan``
    A seeded, fully deterministic fault schedule.  Each spec names a fault
    kind and an *address* — counting level ``k``, mapper ``slot``, retry
    ``attempt`` for mapper faults; checkpoint ``step``/``tensor`` for
    snapshot faults — with ``None`` fields acting as wildcards and ``times``
    bounding how often the spec fires.  Runners and the checkpointer consult
    the plan at well-defined points (mapper launch, count dispatch, tensor
    write, commit), so a given plan against a given workload injects exactly
    the same faults every run.

``RetryPolicy``
    Hadoop-style task recovery knobs for ``SimRunner``: bounded per-mapper
    retries with exponential backoff, an optional per-task timeout, and
    speculative re-execution of stragglers (first result wins, duplicates
    discarded — counts stay exactly equal to the sequential reference).

Mapper fault kinds (applied inside the mapper, so thread *and* process
pools see them):

=============  ==========================================================
``crash``      the mapper raises ``MapperCrashError`` (task attempt dies)
``hang``       the mapper sleeps ``delay`` seconds first (a straggler)
``corrupt``    the mapper's partial counts are perturbed *after* its
               integrity digest is taken — models corruption in the
               shuffle; the runner detects the digest mismatch and
               re-runs the task (``PartialCorruptionError``)
=============  ==========================================================

Engine/runner fault kinds:

``device_loss``   ``count_async`` (or the level ladder) raises
                  ``DeviceLostError`` at job dispatch after abandoning the
                  engine's outstanding work; a new miner on a fresh runner
                  resumes from the level checkpoint.  One card has no
                  smaller mesh to rebuild onto, so the loss propagates.

``process_exit``  the *real* host failure: at level-``k`` job dispatch,
                  the worker whose rank (``torch.distributed.get_rank()``,
                  0 without a process group) matches ``process`` calls
                  ``os._exit(137)`` — no cleanup, no exception, exactly a
                  killed host.  A rerun resumes from the checkpoint.

Checkpoint fault kinds (consulted by ``distributed.checkpoint.save``):

``torn_write``    truncate tensor ``tensor`` of step ``step`` mid-write and
                  raise ``TornWriteError`` (the ``.tmp`` dir is left behind)
``kill_write``    same truncation, then ``os._exit(137)`` — the real
                  kill-9-mid-save, for subprocess tests
``kill_commit``   ``os._exit(137)`` after the snapshot dir rename but
                  before the ``LATEST`` pointer update
``bitrot``        after a fully committed save, flip a byte in a tensor
                  file of the *final* snapshot (models silent media
                  corruption; restore must catch it via digests)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

MAPPER_KINDS = ("crash", "hang", "corrupt")
CHECKPOINT_KINDS = ("torn_write", "kill_write", "kill_commit", "bitrot")
ALL_KINDS = (MAPPER_KINDS + ("device_loss", "process_exit")
             + CHECKPOINT_KINDS)


class MapperCrashError(RuntimeError):
    """A mapper task attempt died (injected crash)."""


class PartialCorruptionError(RuntimeError):
    """A mapper's partial counts failed their integrity digest."""


class JobFailedError(RuntimeError):
    """A task exhausted ``RetryPolicy.max_attempts`` — the job is dead."""


class DeviceLostError(RuntimeError):
    """A device (subset) was lost mid-run; carries how many died."""

    def __init__(self, lost: int = 1, k: Optional[int] = None) -> None:
        super().__init__(f"lost {lost} device(s)"
                         + (f" during level-{k} dispatch" if k else ""))
        self.lost = lost
        self.k = k


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One addressable fault. ``None`` address fields are wildcards."""

    kind: str
    k: Optional[int] = None        # counting level (mapper / device_loss)
    slot: Optional[int] = None     # mapper slot
    attempt: Optional[int] = 0     # which task attempt (None = every attempt)
    times: int = 1                 # how many times this spec may fire
    delay: float = 0.25            # hang duration (seconds)
    lost: int = 1                  # devices lost (device_loss)
    process: Optional[int] = None  # rank of the process that dies (process_exit)
    step: Optional[int] = None     # checkpoint step (checkpoint kinds)
    tensor: int = 0                # tensor index within the snapshot
    seed: int = 0                  # corruption perturbation seed

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"pick from {list(ALL_KINDS)}")


# -- ergonomic constructors -------------------------------------------------

def crash(k: Optional[int] = None, slot: Optional[int] = None,
          attempt: Optional[int] = 0, times: int = 1) -> FaultSpec:
    return FaultSpec("crash", k=k, slot=slot, attempt=attempt, times=times)


def hang(delay: float = 0.25, k: Optional[int] = None,
         slot: Optional[int] = None, attempt: Optional[int] = 0,
         times: int = 1) -> FaultSpec:
    return FaultSpec("hang", k=k, slot=slot, attempt=attempt, times=times,
                     delay=delay)


def corrupt(k: Optional[int] = None, slot: Optional[int] = None,
            attempt: Optional[int] = 0, times: int = 1,
            seed: int = 0) -> FaultSpec:
    return FaultSpec("corrupt", k=k, slot=slot, attempt=attempt, times=times,
                     seed=seed)


def device_loss(k: Optional[int] = None, lost: int = 1,
                times: int = 1) -> FaultSpec:
    return FaultSpec("device_loss", k=k, lost=lost, times=times)


def process_exit(k: Optional[int] = None, process: int = 0,
                 times: int = 1) -> FaultSpec:
    """Kill worker ``process`` (its rank) at level-``k`` dispatch."""
    return FaultSpec("process_exit", k=k, process=process, times=times)


def torn_write(step: Optional[int] = None, tensor: int = 0) -> FaultSpec:
    return FaultSpec("torn_write", step=step, tensor=tensor)


def kill_write(step: Optional[int] = None, tensor: int = 0) -> FaultSpec:
    return FaultSpec("kill_write", step=step, tensor=tensor)


def kill_commit(step: Optional[int] = None) -> FaultSpec:
    return FaultSpec("kill_commit", step=step)


def bitrot(step: Optional[int] = None, tensor: int = 0,
           seed: int = 0) -> FaultSpec:
    return FaultSpec("bitrot", step=step, tensor=tensor, seed=seed)


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """The picklable per-task fault order shipped into a pool worker."""

    kind: str
    delay: float = 0.0
    seed: int = 0


class FaultPlan:
    """A consumable, deterministic schedule of ``FaultSpec``s.

    Specs fire at most ``times`` each, matched in declaration order at every
    consultation point.  A plan holds mutable per-spec counters, so build a
    *fresh* plan per run (a consumed plan injects nothing).  ``injected``
    logs every fault that actually fired, for assertions and telemetry.
    """

    def __init__(self, *specs: FaultSpec, seed: int = 0) -> None:
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(s).__name__}")
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed
        self._remaining: List[int] = [s.times for s in specs]
        self.injected: List[Tuple[str, Dict]] = []

    @classmethod
    def chaos(cls, n_faults: int = 3, kinds=MAPPER_KINDS, seed: int = 0,
              min_k: int = 1, max_k: int = 4, n_slots: int = 4,
              delay: float = 0.05) -> "FaultPlan":
        """A seeded random mapper-fault schedule with *precise* addresses
        (every spec pins k/slot/attempt=0), so injection stays deterministic
        even under nondeterministic pool scheduling."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            k = int(rng.integers(min_k, max_k + 1))
            slot = int(rng.integers(n_slots))
            if kind == "hang":
                specs.append(hang(delay=delay, k=k, slot=slot))
            elif kind == "corrupt":
                specs.append(corrupt(k=k, slot=slot,
                                     seed=int(rng.integers(2**31))))
            else:
                specs.append(crash(k=k, slot=slot))
        return cls(*specs, seed=seed)

    # -- matching ----------------------------------------------------------
    def _take(self, kinds, **addr) -> Optional[FaultSpec]:
        for i, spec in enumerate(self.specs):
            if spec.kind not in kinds or self._remaining[i] <= 0:
                continue
            if any(getattr(spec, f) is not None and getattr(spec, f) != v
                   for f, v in addr.items()):
                continue
            self._remaining[i] -= 1
            self.injected.append((spec.kind, dict(addr)))
            return spec
        return None

    def mapper_action(self, *, k: int, slot: int,
                      attempt: int) -> Optional[FaultAction]:
        """Fault order for one mapper task attempt (None = run clean)."""
        spec = self._take(MAPPER_KINDS, k=k, slot=slot, attempt=attempt)
        if spec is None:
            return None
        return FaultAction(spec.kind, delay=spec.delay, seed=spec.seed)

    def device_loss(self, *, k: int) -> Optional[FaultSpec]:
        """Device-loss order at the dispatch of a level-k counting job."""
        return self._take(("device_loss",), k=k)

    def process_exit(self, *, k: int, process: int) -> Optional[FaultSpec]:
        """Process-death order at level-k dispatch, addressed by the
        caller's own rank — only the doomed worker's
        consultation fires (each process holds its own plan copy)."""
        return self._take(("process_exit",), k=k, process=process)

    def checkpoint_action(self, *, step: int, tensor: Optional[int] = None,
                          stage: str = "tensor") -> Optional[FaultSpec]:
        """Checkpoint fault order. ``stage`` is ``"tensor"`` (per tensor
        write), ``"commit"`` (between dir rename and LATEST update) or
        ``"committed"`` (after a fully successful save)."""
        if stage == "tensor":
            return self._take(("torn_write", "kill_write"),
                              step=step, tensor=tensor)
        if stage == "commit":
            return self._take(("kill_commit",), step=step)
        if stage == "committed":
            return self._take(("bitrot",), step=step)
        raise ValueError(f"unknown checkpoint stage {stage!r}")

    @property
    def exhausted(self) -> bool:
        return all(r <= 0 for r in self._remaining)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Hadoop-style task recovery for ``SimRunner`` mapper waves.

    ``max_attempts``     total attempts per mapper slot (original + retries
                         + speculative backups) before ``JobFailedError``
    ``backoff``          base retry backoff (seconds); attempt ``a`` waits
                         ``backoff * backoff_factor**a``
    ``timeout``          per-task absolute straggler threshold (seconds);
                         ``None`` derives one from completed-task walls
    ``speculation``      launch a backup copy of a straggler task (pooled
                         executors); first result wins, the duplicate is
                         discarded — counts never change
    ``speculation_factor``   dynamic threshold = factor x median completed
                             task wall (needs >= half the slots finished)
    ``speculation_min_wait`` floor for the dynamic threshold, so quick jobs
                             never speculate spuriously
    """

    max_attempts: int = 4
    backoff: float = 0.01
    backoff_factor: float = 2.0
    timeout: Optional[float] = None
    speculation: bool = True
    speculation_factor: float = 3.0
    speculation_min_wait: float = 0.25


DEFAULT_RETRY = RetryPolicy()


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without
    one: the address a ``process_exit`` fault names, and the only rank
    that writes checkpoints."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def partial_digest(partial: dict) -> int:
    """Order-insensitive integrity digest of a mapper's partial counts.

    ``hash(frozenset(...))`` is all C-level and an order of magnitude
    cheaper than a cryptographic hash of the sorted items — this runs twice
    per task attempt (in-worker and at the host's shuffle boundary) on
    every clean job, so it is on the robustness-tax hot path.
    Deterministic across host and pool processes because the keys are ints
    or int tuples (CPython only randomizes str/bytes hashing); this is a
    corruption tripwire, not a cryptographic commitment."""
    return hash(frozenset(partial.items()))


def corrupt_partial(partial: dict, seed: int) -> dict:
    """Deterministically perturb one partial count (post-digest, so the
    runner's integrity check must catch it). Empty partials pass through —
    there is nothing to corrupt."""
    if not partial:
        return partial
    rng = np.random.default_rng(seed)
    out = dict(partial)
    key = sorted(out)[int(rng.integers(len(out)))]
    out[key] = int(out[key]) + int(rng.integers(1, 1000))
    return out
