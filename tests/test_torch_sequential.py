"""PyTorch port vs JAX package: the paper's three sequential structures and
the Hadoop cluster model (``SimRunner`` through ``run_mapreduce_apriori``).

The port keeps its own copies of the pure-Python structures; the same
seeded inputs must give the same counts, the same generated candidates (in
the same order), and through ``run_mapreduce_apriori`` the same itemsets,
supports and ``JobProfile`` ``k``/``n_candidates``/``n_frequent`` rows, with
no tolerance.
"""

import itertools
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.hadoop_sim import run_mapreduce_apriori as j_run  # noqa: E402
from repro.core.itemsets import sort_level  # noqa: E402
from repro.core.sequential import SEQUENTIAL_STORES as J_STORES  # noqa: E402
from repro.data import get_dataset as j_get_dataset  # noqa: E402
from test_sequential import DB  # noqa: E402
from test_store_properties import EDGE_DBS  # noqa: E402

from repro_torch.core.hadoop_sim import (  # noqa: E402
    HadoopSimResult,
    IterationProfile,
    run_mapreduce_apriori as t_run,
)
from repro_torch.core.runtime import JobProfile  # noqa: E402
from repro_torch.core.sequential import (  # noqa: E402
    SEQUENTIAL_STORES as T_STORES,
    HashTree,
)

STRUCTURES = list(J_STORES)


def _levels(res):
    return [(p.k, p.n_candidates, p.n_frequent) for p in res.iterations]


def _pipeline_db():
    """``test_sequential``'s seeded 200-basket, 20-item database."""
    rng = np.random.default_rng(0)
    return [sorted(set(rng.integers(0, 20, size=rng.integers(2, 8)).tolist()))
            for _ in range(200)]


def test_same_structures_by_name():
    assert list(T_STORES) == list(J_STORES)
    assert [c.name for c in T_STORES.values()] == STRUCTURES


@pytest.mark.parametrize("name", STRUCTURES)
@given(db=DB, k=st.integers(1, 3))
@settings(max_examples=20, deadline=None)
def test_counting_matches_reference(name, db, k):
    items = sorted({int(i) for t in db for i in t})
    cands = list(itertools.combinations(items[:10], k))[:25]
    stores = [J_STORES[name](cands), T_STORES[name](cands)]
    for t in db:
        for store in stores:
            store.count_transaction(t)
    assert stores[1].counts() == stores[0].counts()
    for c in cands:
        assert stores[1].contains(c) == stores[0].contains(c)


@pytest.mark.parametrize("name", ["trie", "hash_table_trie"])
@given(level=st.sets(st.frozensets(st.integers(0, 10), min_size=2, max_size=3),
                     min_size=1, max_size=25))
@settings(max_examples=25, deadline=None)
def test_generation_matches_reference(name, level):
    by_len = {}
    for s in level:
        by_len.setdefault(len(s), []).append(tuple(sorted(s)))
    for rows in by_len.values():
        rows = sort_level(rows)
        assert (T_STORES[name](rows).generate_candidates()
                == J_STORES[name](rows).generate_candidates())


@pytest.mark.parametrize("name", STRUCTURES)
@pytest.mark.parametrize("case", range(len(EDGE_DBS)))
def test_edge_dbs_match_reference(name, case):
    _, db = EDGE_DBS[case]
    cands = [(0,), (4,), (0, 1), (0, 4), (1, 2), (0, 1, 2)]
    for k in (1, 2, 3):
        ck = [c for c in cands if len(c) == k]
        stores = [J_STORES[name](ck), T_STORES[name](ck)]
        for t in db:
            for store in stores:
                store.count_transaction(t)
        assert stores[1].counts() == stores[0].counts()
    want = j_run(db, 0.2, structure=name, n_mappers=3)
    got = t_run(db, 0.2, structure=name, n_mappers=3)
    assert got.itemsets == want.itemsets
    assert got.min_count == want.min_count
    assert _levels(got) == _levels(want)


def test_hash_tree_params_match_reference():
    """child_max_size=20 with leaf_max_size ignored (paper §5.2), and the
    classic size-triggered split."""
    cands = list(itertools.combinations(range(40), 3))[:200]
    for kw, cs in (({"child_max_size": 20, "leaf_max_size": None}, cands),
                   ({"child_max_size": 5, "leaf_max_size": 4},
                    list(itertools.combinations(range(12), 2)))):
        tree = HashTree(cs, **kw)
        ref = J_STORES["hash_tree"](cs, **kw)
        for c in cs + [(37, 38, 39), (10, 11)]:
            assert tree.contains(c) == ref.contains(c)
        assert tree.counts() == ref.counts()


@pytest.mark.parametrize("structure", STRUCTURES)
@pytest.mark.parametrize("n_mappers", [1, 3, 4])
@pytest.mark.parametrize("data", ["pipeline", "T10I4D100K"])
def test_run_mapreduce_apriori_matches_reference(structure, n_mappers, data):
    if data == "pipeline":
        db, support = _pipeline_db(), 0.08
    else:
        db, support = j_get_dataset("T10I4D100K", scale=0.002, seed=0), 0.02
    want = j_run(db, support, structure=structure, n_mappers=n_mappers)
    got = t_run(db, support, structure=structure, n_mappers=n_mappers)
    assert isinstance(got, HadoopSimResult)
    assert got.itemsets == want.itemsets and got.itemsets
    assert (got.structure, got.n_mappers, got.min_count) == \
        (want.structure, want.n_mappers, want.min_count)
    assert _levels(got) == _levels(want)
    assert all(len(p.mapper_seconds) == n_mappers for p in got.iterations)
    assert got.parallel_seconds <= got.sequential_seconds + 1e-9


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_pooled_mappers_match_reference(executor):
    """Mappers on a real pool: counts equal the sequential reference, the
    per-mapper clocks come back from the workers."""
    db = _pipeline_db()
    want = j_run(db, 0.08, structure="trie", n_mappers=4)
    got = t_run(db, 0.08, structure="trie", n_mappers=4, executor=executor)
    assert got.itemsets == want.itemsets
    assert _levels(got) == _levels(want)
    assert all(len(p.mapper_seconds) == 4 for p in got.iterations)


def test_structures_pickle_for_process_pools():
    cands = [(0, 1), (0, 2), (1, 2)]
    for name, cls in T_STORES.items():
        assert pickle.loads(pickle.dumps(cls)) is cls
        store = cls(cands)
        store.count_transaction([0, 1, 2])
        assert pickle.loads(pickle.dumps(store)).counts() == store.counts()


def test_unknown_structure_and_alias():
    with pytest.raises(ValueError, match="unknown structure"):
        t_run([[0]], 0.5, structure="btree")
    assert IterationProfile is JobProfile
