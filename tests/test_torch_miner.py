"""PyTorch port vs JAX package: the whole mining path.

``FrequentItemsetMiner.mine`` on both packages must give the same itemsets
AND supports, and the same ``k`` / ``n_candidates`` / ``n_frequent`` on
every ``JobProfile`` row, for every ported store with the kernel switch on
and off.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.miner import FrequentItemsetMiner as JMiner  # noqa: E402
from repro.data import get_dataset as j_get_dataset  # noqa: E402
from test_store_properties import EDGE_DBS  # noqa: E402

from repro_torch.core.miner import FrequentItemsetMiner as TMiner  # noqa: E402
from repro_torch.core.runtime import strategies  # noqa: E402
from repro_torch.core.runtime.job import CountJob, JobProfile  # noqa: E402
from repro_torch.core.stores import ARRAY_STORES  # noqa: E402

CONFIGS = [("perfect_hash", False), ("bitmap", False), ("bitmap", True),
           ("packed_bitmap", False), ("packed_bitmap", True)]
T10_SUPPORT = 0.02
_REF = {}


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
                   {"checkpoint_dir": "ckpt"}, {"device_loop": True},
                   {"runner": object()}):
        with pytest.raises(NotImplementedError):
            TMiner(device="cpu", **kwargs)
    for name in ("fpc", "dpc"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            TMiner(strategy=name, device="cpu").mine([[0, 1], [0, 1]])
    with pytest.raises(ValueError):
        strategies.get("nope")
