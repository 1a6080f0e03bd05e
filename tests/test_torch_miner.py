"""PyTorch port vs JAX package: the whole mining path.

``FrequentItemsetMiner.mine`` on both packages must give the same itemsets
AND supports, and the same ``k`` / ``n_candidates`` / ``n_frequent`` on
every ``JobProfile`` row, for every store with the kernel switch on and
off, under SPC and the combined-pass strategies FPC and DPC.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.miner import FrequentItemsetMiner as JMiner  # noqa: E402
from repro.data import get_dataset as j_get_dataset  # noqa: E402
from test_store_properties import EDGE_DBS, _random_db  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401

from repro_torch.core.miner import FrequentItemsetMiner as TMiner  # noqa: E402
from repro_torch.core.runtime import strategies  # noqa: E402
from repro_torch.core.runtime.job import CountJob, JobProfile  # noqa: E402
from repro_torch.core.stores import ARRAY_STORES  # noqa: E402

CONFIGS = [("perfect_hash", False), ("bitmap", False), ("bitmap", True),
           ("packed_bitmap", False), ("packed_bitmap", True)]
COMBINED_CONFIGS = [("perfect_hash", None), ("sorted_prefix", None),
                    ("hash_bucket", None), ("bitmap", None), ("bitmap", True),
                    ("packed_bitmap", None), ("packed_bitmap", True)]
T10_SUPPORT = 0.02
# FPC's speculative C3/C4 from T10I4D100K's 218-item L1 at 0.02 would be
# ~1.7M/~90M rows, so the combined strategies mine it at 0.04 (15 frequent
# items) with max_k = 4, where DPC's budget would otherwise let one job
# count every subset of the 15 items (32,752 candidates up to k = 15).
T10_COMBINED_SUPPORT = 0.04
T10_COMBINED_MAX_K = 4
_REF = {}
_COMBINED_REF = {}


def _levels(res):
    return [(p.k, p.n_candidates, p.n_frequent) for p in res.levels]


def _reference(store, name):
    if (store, name) not in _REF:
        if name == "T10I4D100K":
            db, support = j_get_dataset("T10I4D100K", scale=0.002), T10_SUPPORT
        else:
            db, support = EDGE_DBS[name][1], 0.2
        res = JMiner(min_support=support, store=store).mine(db)
        _REF[(store, name)] = (db, support, res)
    return _REF[(store, name)]


@pytest.mark.parametrize("store,use_kernel", CONFIGS)
@pytest.mark.parametrize("name", ["T10I4D100K"] + list(range(len(EDGE_DBS))))
def test_mine_matches_reference(store, use_kernel, name, monkeypatch):
    if use_kernel:
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", True)
    db, support, want = _reference(store, name)
    got = TMiner(min_support=support, store=store, device="cpu").mine(db)
    assert got.itemsets == want.itemsets
    assert _levels(got) == _levels(want)
    assert got.min_count == want.min_count
    assert got.n_transactions == want.n_transactions
    np.testing.assert_array_equal(got.item_map, want.item_map)
    if name == "T10I4D100K":
        assert got.max_k >= 2 and len(got.levels) >= 2


def _combined_reference(strategy, name):
    if (strategy, name) not in _COMBINED_REF:
        max_k = 16  # the miners' default
        if name == "T10I4D100K":
            db = j_get_dataset("T10I4D100K", scale=0.002)
            support, max_k = T10_COMBINED_SUPPORT, T10_COMBINED_MAX_K
        elif isinstance(name, str):
            db, support = _random_db(int(name[4:]))[1], 0.2
        else:
            db, support = EDGE_DBS[name][1], 0.2
        res = JMiner(min_support=support, strategy=strategy,
                     max_k=max_k).mine(db)
        _COMBINED_REF[(strategy, name)] = (db, support, max_k, res)
    return _COMBINED_REF[(strategy, name)]


@pytest.mark.parametrize("store,use_kernel", COMBINED_CONFIGS)
@pytest.mark.parametrize("strategy", ["fpc", "dpc"])
@pytest.mark.parametrize("name", ["seed0", "seed2", "T10I4D100K"]
                         + list(range(len(EDGE_DBS))))
def test_combined_strategies_match_reference(store, use_kernel, strategy,
                                             name, monkeypatch):
    """FPC/DPC against the JAX package's (its ``perfect_hash`` mine: the
    JAX suite holds its stores to one answer).  ``inflight=8`` keeps every
    wave of a combined job outstanding until the job resolves them."""
    if hasattr(ARRAY_STORES[store], "use_kernel"):
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", use_kernel)
    db, support, max_k, want = _combined_reference(strategy, name)
    got = TMiner(min_support=support, store=store, strategy=strategy,
                 max_k=max_k, inflight=8, cand_block=512,
                 device="cpu").mine(db)
    assert got.itemsets == want.itemsets
    assert _levels(got) == _levels(want)
    assert got.min_count == want.min_count


def test_combined_job_profile_aggregates_waves():
    """One combined job's profile: its top k, the sum of its waves'
    candidates, the surviving itemsets, and the wave fields summed (or
    maxed, for the queue depth) as the JAX strategy does."""
    db, support, _, want = _combined_reference("fpc", "seed2")
    got = TMiner(min_support=support, strategy="fpc", device="cpu").mine(db)
    for g, w in zip(got.levels, want.levels):
        assert (g.k, g.n_candidates, g.n_frequent, g.inflight_depth,
                g.inflight_retunes, g.retries, g.mapper_seconds) == \
            (w.k, w.n_candidates, w.n_frequent, w.inflight_depth,
             w.inflight_retunes, w.retries, w.mapper_seconds)
    job = got.levels[1]
    assert job.seconds >= job.count_seconds >= 0
    assert job.encode_seconds > 0 and job.gen_seconds > 0


def test_closure_filter_matches_reference():
    from repro.core.runtime.strategies import _closure_filter as j_closure

    rng = np.random.default_rng(5)
    frequent = {}
    for k in (1, 2, 3):
        for _ in range(40):
            s = tuple(sorted(rng.choice(8, k, replace=False).tolist()))
            frequent[s] = int(rng.integers(1, 9))
    got = strategies._closure_filter(frequent)
    assert got == j_closure(frequent) and len(got) < len(frequent)
    assert strategies._closure_filter({}) == {}


@pytest.mark.parametrize("inflight", [0, None])
def test_mine_matches_reference_at_any_depth(inflight):
    db, support, want = _reference("perfect_hash", "T10I4D100K")
    got = TMiner(min_support=support, inflight=inflight, cand_block=4096,
                 device="cpu").mine(db)
    assert got.itemsets == want.itemsets
    assert _levels(got) == _levels(want)


def test_job_profile_fields_match_reference():
    from repro.core.runtime.job import JobProfile as JProfile

    assert [f.name for f in dataclasses.fields(JobProfile)] == \
        [f.name for f in dataclasses.fields(JProfile)]
    row = dataclasses.asdict(JobProfile(k=2, n_candidates=5, n_frequent=1))
    assert row == dataclasses.asdict(JProfile(k=2, n_candidates=5, n_frequent=1))
    assert CountJob(k=2, cand=np.zeros((0, 2), np.int32)).n_candidates == 0


def test_unported_options_raise():
    for kwargs in ({"mesh": object()}, {"cand_axes": ("cand",)},
                   {"checkpoint_dir": "ckpt"}, {"runner": object()}):
        with pytest.raises(NotImplementedError):
            TMiner(device="cpu", **kwargs)
    # The ladder and FPC/DPC are ported; the ladder fuses SPC only, as in
    # the JAX package.
    for name in ("fpc", "dpc"):
        got = TMiner(strategy=name, device="cpu").mine([[0, 1], [0, 1]])
        assert got.itemsets == {(0,): 2, (1,): 2, (0, 1): 2}
        with pytest.raises(ValueError, match="device_loop"):
            TMiner(strategy=name, device_loop=True, device="cpu")
    assert TMiner(device_loop=True, device="cpu").mine(
        [[0, 1], [0, 1]]).itemsets == {(0,): 2, (1,): 2, (0, 1): 2}
    with pytest.raises(ValueError):
        strategies.get("nope")
