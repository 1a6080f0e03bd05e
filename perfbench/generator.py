"""The benchmark's own IBM Quest generator, vectorised over baskets.

The rules are those of ``repro_torch.data.transactions.quest_generator``
(itself the IBM Quest procedure of Agrawal and Srikant, VLDB'94, sec.
2.4.3): a pool of potentially large patterns, each chained to the one
before it by an exponentially distributed share of common items; pattern
weights drawn from an exponential and normalised; a per-pattern corruption
level drawn from N(corruption_mean, corruption_sd) clipped to [0, 0.95];
Poisson basket lengths (at least 1).  A basket draws patterns by weight,
keeps each item of a drawn pattern unless the pattern's corruption drops
it, and adds the kept items until it holds its length; a pattern that would
take the basket past 1.5 times its length ends the basket instead (unless
the basket is still empty).

The database is always drawn from ``DATA_SEED``; a run's seed only shuffles
it, putting the baskets in another order and the items under other ids, so
every seed counts the same lattice, level by level the same sizes, as other
rows and other candidates.  The pattern pool and the lengths are drawn on
the host with NumPy; the per-basket draws run for all unfinished baskets at
once, one round per pattern drawn, with a ``torch.Generator`` on
``device``.  A seed gives the same baskets on one kind of device; the CPU
and a CUDA card draw different streams.  This module imports nothing of
the program.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import List

import numpy as np
import torch

DATA_SEED = 0  # every run draws this database, then shuffles it by its seed


@dataclasses.dataclass
class Baskets:
    """A basket database as flat arrays: basket ``i`` is
    ``items[offsets[i]:offsets[i + 1]]``, ascending and distinct."""

    items: np.ndarray    # int32, all baskets' items one after the other
    offsets: np.ndarray  # int64, N + 1 entries
    n_items: int         # the item vocabulary (ids lie in [0, n_items))

    @property
    def n_baskets(self) -> int:
        return int(self.offsets.shape[0] - 1)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def as_lists(self) -> List[List[int]]:
        """Lists of Python ints, the form the program's ``ingest`` takes.
        The cyclic collector is held off while they are made: a million
        new lists would start it hundreds of times for nothing."""
        enabled = gc.isenabled()
        gc.disable()
        try:
            flat = self.items.tolist()
            o = self.offsets.tolist()
            return [flat[o[i]:o[i + 1]] for i in range(len(o) - 1)]
        finally:
            if enabled:
                gc.enable()


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number (negative or past 64 bits too) as a NumPy seed."""
    return np.random.SeedSequence(int(seed) % (1 << 64))


def pattern_pool(rng: np.random.Generator, n_items: int, n_patterns: int,
                 avg_pattern_len: float, corruption_mean: float,
                 corruption_sd: float):
    """(patterns, weights, corruption): the chained pattern pool."""
    sizes = np.maximum(1, rng.poisson(avg_pattern_len, n_patterns))
    prev = rng.choice(n_items, size=sizes[0], replace=False)
    patterns = [np.sort(prev)]
    for s in sizes[1:]:
        n_common = min(len(prev), int(rng.exponential(0.5) * s))
        common = (rng.choice(prev, size=n_common, replace=False)
                  if n_common else np.empty(0, np.int64))
        fresh = rng.choice(n_items, size=max(1, s - n_common), replace=False)
        pat = np.unique(np.concatenate([common, fresh]))
        patterns.append(pat)
        prev = pat
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()
    corruption = np.clip(rng.normal(corruption_mean, corruption_sd,
                                    n_patterns), 0.0, 0.95)
    return patterns, weights, corruption


def quest(n_transactions: int, avg_transaction_len: float,
          avg_pattern_len: float, n_items: int = 1000,
          n_patterns: int = 2000, corruption_mean: float = 0.5,
          corruption_sd: float = 0.1, seed: int = 0,
          device="cpu") -> Baskets:
    """The Quest baskets of ``DATA_SEED``, shuffled by ``seed`` (see the
    module docstring)."""
    dev = torch.device(device)
    held = _draw(n_transactions, avg_transaction_len, avg_pattern_len,
                 n_items, n_patterns, corruption_mean, corruption_sd,
                 DATA_SEED, dev)
    rng = np.random.default_rng(seed_sequence(seed))
    rows = torch.from_numpy(rng.permutation(n_transactions)).to(dev)
    ids = torch.from_numpy(rng.permutation(n_items)).to(dev)
    relabelled = torch.empty_like(held)
    relabelled[:, ids] = held  # item i is called ids[i]
    held = relabelled[rows]
    counts = held.sum(1)
    flat = held.nonzero()[:, 1].to(torch.int32)  # row-major: rows ascending
    offsets = np.zeros((n_transactions + 1,), np.int64)
    np.cumsum(counts.cpu().numpy(), out=offsets[1:])
    return Baskets(items=flat.cpu().numpy(), offsets=offsets, n_items=n_items)


def _draw(n_transactions, avg_transaction_len, avg_pattern_len, n_items,
          n_patterns, corruption_mean, corruption_sd, seed,
          dev) -> torch.Tensor:
    """The (N, n_items) bool matrix of the baskets that ``seed`` draws."""
    ss = seed_sequence(seed)
    rng = np.random.default_rng(ss)
    patterns, weights, corruption = pattern_pool(
        rng, n_items, n_patterns, avg_pattern_len, corruption_mean,
        corruption_sd)
    tlens = np.maximum(1, rng.poisson(avg_transaction_len, n_transactions))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    width = max(len(p) for p in patterns)
    pat = np.full((n_patterns, width), n_items, np.int64)  # n_items: no item
    for i, p in enumerate(patterns):
        pat[i, :len(p)] = p
    pat_t = torch.from_numpy(pat).to(dev)
    cum = torch.from_numpy(np.cumsum(weights)).to(dev)
    corr = torch.from_numpy(corruption).to(dev)
    limit = torch.from_numpy(tlens).to(dev)
    oversize = limit.to(torch.float64) * 1.5

    held = torch.zeros((n_transactions, n_items + 1), dtype=torch.bool,
                       device=dev)
    size = torch.zeros((n_transactions,), dtype=torch.int64, device=dev)
    active = torch.arange(n_transactions, device=dev)
    while active.numel():
        a = active.numel()
        u = torch.rand((a,), generator=gen, dtype=torch.float64, device=dev)
        p = torch.searchsorted(cum, u).clamp_(max=n_patterns - 1)
        items = pat_t[p]                                        # (A, width)
        keep = torch.rand((a, width), generator=gen, device=dev) \
            >= corr[p].to(torch.float32)[:, None]
        keep &= items < n_items
        before = size[active]
        # A drawn pattern that would overfill a non-empty basket ends it.
        ends = (before + keep.sum(1) > oversize[active]) & (before > 0)
        take = ~ends
        rows, items, keep = active[take], items[take], keep[take]
        items = torch.where(keep, items, n_items)
        new = (~held[rows[:, None], items]) & keep
        held[rows[:, None], items] = True
        size[rows] += new.sum(1)
        full = size[active] >= limit[active]
        active = active[~(ends | full)]
    return held[:, :n_items]


def from_config(cfg: dict, seed: int, device="cpu") -> Baskets:
    """The baskets a configuration file describes."""
    return quest(n_transactions=int(cfg["n_transactions"]),
                 avg_transaction_len=cfg["avg_transaction_len"],
                 avg_pattern_len=cfg["avg_pattern_len"],
                 n_items=int(cfg["n_items"]),
                 n_patterns=int(cfg["n_patterns"]),
                 corruption_mean=cfg["corruption_mean"],
                 corruption_sd=cfg["corruption_sd"], seed=seed,
                 device=device)
