"""PyTorch port vs JAX package: the device-resident level ladder.

``join_pair_count`` and ``apriori_gen_device`` against the JAX package's
(row order included), and ``FrequentItemsetMiner(device_loop=True)``
against the JAX package's ladder mine on the store-property suite's
databases and a small T10I4D100K, trim on and off, through every store
(the kernel stores with the switch on and off).  Itemsets, supports and
each level's ``(k, n_candidates, n_frequent, n_pad, f_pad)`` must be
identical.  The reference mine runs JAX's ``perfect_hash`` store: its own
suite holds every JAX store's ladder to the same brute-force answer, and
the level rows do not depend on the store.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import itemsets as J  # noqa: E402
from repro.core.miner import FrequentItemsetMiner as JMiner  # noqa: E402
from repro.core.runtime import device_loop as J_dl  # noqa: E402
from repro.data import get_dataset as j_get_dataset  # noqa: E402
from test_store_properties import EDGE_DBS, _random_db  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401

from repro_torch.core.miner import FrequentItemsetMiner as TMiner  # noqa: E402
from repro_torch.core.runtime import device_loop as T_dl  # noqa: E402
from repro_torch.core.runtime.engine import MapReduceEngine  # noqa: E402
from repro_torch.core.stores import ARRAY_STORES  # noqa: E402

CONFIGS = [("perfect_hash", None), ("sorted_prefix", None),
           ("hash_bucket", None), ("bitmap", None), ("bitmap", False),
           ("bitmap", True), ("packed_bitmap", None),
           ("packed_bitmap", False), ("packed_bitmap", True)]
CASES = ["seed0", "seed2", "T10I4D100K"] + [f"edge{i}" for i in range(len(EDGE_DBS))]
_REF = {}


def _case(name):
    if name == "T10I4D100K":
        return j_get_dataset("T10I4D100K", scale=0.002), 0.02
    if name.startswith("seed"):
        return _random_db(int(name[4:]))[1], 0.2
    return EDGE_DBS[int(name[4:])][1], 0.2


def _rows(res):
    return [(p.k, p.n_candidates, p.n_frequent, p.n_pad, p.f_pad)
            for p in res.levels]


def _reference(name, trim):
    if (name, trim) not in _REF:
        db, support = _case(name)
        res = JMiner(min_support=support, device_loop=True, trim=trim).mine(db)
        _REF[(name, trim)] = (db, support, res)
    return _REF[(name, trim)]


def _level(rng, k, n_items, n_rows):
    rows = {tuple(sorted(rng.choice(n_items, k, replace=False).tolist()))
            for _ in range(n_rows)}
    return J.level_to_matrix(sorted(rows))


@pytest.mark.parametrize("seed", range(6))
def test_join_pair_count_and_gen_match_reference(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 5))
    mat = _level(rng, k, int(rng.integers(k + 1, 24)), int(rng.integers(1, 90)))
    assert T_dl.join_pair_count(mat) == J_dl.join_pair_count(mat)
    got = T_dl.apriori_gen_device(mat)
    want = np.asarray(J_dl.apriori_gen_device(mat))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, J.apriori_gen_matrix(mat))


def test_gen_edges_and_chunked_pair_mask(monkeypatch):
    """Empty and one-row levels; then a bound small enough to split the
    prefix-pair mask and the membership tests into many row chunks."""
    for mat in (np.zeros((0, 2), np.int32), np.array([[3, 5]], np.int32),
                np.arange(7, dtype=np.int32)[:, None]):
        assert T_dl.join_pair_count(mat) == J_dl.join_pair_count(mat)
        np.testing.assert_array_equal(T_dl.apriori_gen_device(mat),
                                      J.apriori_gen_matrix(mat))
    mat = _level(np.random.default_rng(11), 2, 30, 200)
    monkeypatch.setattr(T_dl, "_MAX_EQ_ELEMENTS", 3 * mat.shape[0])
    np.testing.assert_array_equal(T_dl.apriori_gen_device(mat),
                                  J.apriori_gen_matrix(mat))


@pytest.mark.parametrize("store,use_kernel", CONFIGS)
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_ladder_mine_matches_reference(store, use_kernel, trim, name,
                                       monkeypatch):
    """Small row blocks and candidate chunks, so the count loops and the
    plain paths' chunking of a level are exercised."""
    if hasattr(ARRAY_STORES[store], "use_kernel"):
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", use_kernel)
    db, support, want = _reference(name, trim)
    got = TMiner(min_support=support, store=store, device_loop=True,
                 trim=trim, block_n=64, cand_block=4096, device="cpu").mine(db)
    assert got.itemsets == want.itemsets
    assert _rows(got) == _rows(want)
    assert (got.min_count, got.n_transactions) == (want.min_count,
                                                   want.n_transactions)
    np.testing.assert_array_equal(got.item_map, want.item_map)


def test_ladder_trim_with_chunked_masks(monkeypatch):
    """The pair mask, the prune and the trim under a tiny chunk bound."""
    db, support, want = _reference("seed2", True)
    monkeypatch.setattr(T_dl, "_MAX_EQ_ELEMENTS", 4)
    got = TMiner(min_support=support, device_loop=True, device="cpu").mine(db)
    assert got.itemsets == want.itemsets and _rows(got) == _rows(want)


def test_ladder_refusals():
    with pytest.raises(ValueError, match="engine-backed"):
        list(T_dl.ladder(object(), np.zeros((1, 1), np.int32), 1, 2, 4))
    lad = T_dl.LevelLadder(MapReduceEngine(device="cpu"), min_count=1)
    with pytest.raises(ValueError, match="does not match"):
        list(lad.run(np.zeros((2, 2), np.int32), start_k=2, max_k=4))
    with pytest.raises(RuntimeError, match="place"):
        list(lad.run(np.zeros((2, 1), np.int32), start_k=2, max_k=4))
    assert list(lad.run(np.zeros((0, 1), np.int32), start_k=2, max_k=4)) == []
