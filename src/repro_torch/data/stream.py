"""Seeded basket streams: replay registry datasets as timestamped arrivals
(copied from the JAX package's ``data/stream.py``: the same seed gives the
same baskets, order and timestamps).

The serving layer consumes transactions as *arrival batches* — a burst of
baskets posted within one tick of a Poisson-ish arrival process — rather
than a monolithic DB.  ``basket_stream`` replays any registered dataset
(``data/datasets.py``) as such a stream: the dataset rows become the
arrival order (optionally shuffled), batch sizes are drawn around a target
rate, and each basket carries a monotonically increasing timestamp.  Seeded
end to end, so a stream is exactly reproducible.

Determinism is keyed **per arrival, not per draw**: each epoch derives
three independent RNG streams from ``SeedSequence([seed, tag, epoch,
stream])`` — one for the epoch's permutation, one for the per-basket
inter-arrival jitter (drawn vectorized over the whole epoch, so basket
``j``'s timestamp is a pure function of ``(seed, epoch, j)``), and one for
batch-size draws.  Cutting the same stream into different ``batch_size``
ticks therefore never perturbs the arrival order or the timestamps — only
which tick a basket lands in.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.data.datasets import get_dataset


@dataclasses.dataclass
class ArrivalBatch:
    """One tick of the stream: the baskets that arrived by ``t_arrival``."""

    transactions: List[List[int]]
    t_arrival: float               # seconds since stream start (synthetic)
    seq: int                       # batch index, 0-based
    # Per-basket arrival times (same length as ``transactions``); the last
    # entry equals ``t_arrival``.  Keyed per arrival, so these are identical
    # across any batch_size cutting of the same seeded stream.
    t_arrivals: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.transactions)


def basket_stream(
    dataset: str = "T10I4D100K",
    batch_size: int = 256,
    scale: float = 1.0,
    seed: int = 0,
    shuffle: bool = True,
    jitter: float = 0.25,
    rate: float = 10_000.0,
    repeat: bool = False,
    max_batches: Optional[int] = None,
) -> Iterator[ArrivalBatch]:
    """Replay ``dataset`` as a seeded stream of timestamped arrival batches.

    ``batch_size`` is the mean arrivals per tick; actual sizes jitter
    uniformly within ``±jitter`` of it (clipped to >= 1) — serving code must
    not assume fixed-size batches.  ``rate`` (baskets/sec) sets the synthetic
    arrival clock: each basket's inter-arrival gap is ``1/rate`` jittered
    within ``±jitter``.  ``repeat`` loops the dataset forever (reshuffled per
    epoch when ``shuffle``) for sustained-throughput benchmarks; cap with
    ``max_batches``.  The basket order and per-basket timestamps depend only
    on ``(dataset, scale, seed, shuffle, jitter, rate)`` — never on
    ``batch_size``.
    """
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if not 0.0 <= jitter < 1.0:
        raise ValueError("jitter must be in [0, 1) — gaps must stay positive")
    base = get_dataset(dataset, scale=scale, seed=seed)
    if len(base) == 0:
        return
    lo = max(1, int(round(batch_size * (1.0 - jitter))))
    hi = max(lo, int(round(batch_size * (1.0 + jitter))))
    t0 = 0.0
    seq = 0
    epoch = 0
    while True:
        # Three independent per-epoch streams: consuming from one never
        # shifts another, so replays agree draw-for-draw at any batch_size.
        def erng(stream: int) -> np.random.Generator:
            return np.random.default_rng(
                np.random.SeedSequence([seed, 0x5EED, epoch, stream]))

        order = (erng(1).permutation(len(base)) if shuffle
                 else np.arange(len(base)))
        gaps = (1.0 + jitter * (2.0 * erng(2).random(len(base)) - 1.0)) / rate
        times = t0 + np.cumsum(gaps)
        size_rng = erng(3)
        i = 0
        while i < len(base):
            n = int(size_rng.integers(lo, hi + 1))
            block = [list(base[j]) for j in order[i : i + n]]
            ts = times[i : i + len(block)].copy()
            i += len(block)
            yield ArrivalBatch(transactions=block, t_arrival=float(ts[-1]),
                               seq=seq, t_arrivals=ts)
            seq += 1
            if max_batches is not None and seq >= max_batches:
                return
        if not repeat:
            return
        t0 = float(times[-1])
        epoch += 1
