"""PyTorch port vs JAX package: the parity-cell plumbing (``sweep.py``).

``itemset_digest`` must give the reference's string for the same itemsets,
``aggregate_profiles`` the reference's record for the same rows, and
``run_parity_cell`` over the sim structures and the torch runners on the CPU
the reference cell's digest; a backend that lies about one support raises.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.runtime import JaxRunner  # noqa: E402
from repro.core.runtime import SimRunner as JSimRunner  # noqa: E402
from repro.core.runtime import sweep as j_sweep  # noqa: E402
from repro.core.runtime.job import JobProfile as JProfile  # noqa: E402
from repro.data import get_dataset  # noqa: E402

from repro_torch.core.runtime import (  # noqa: E402
    CellResult,
    JobProfile,
    SimRunner,
    TorchRunner,
    aggregate_profiles,
    itemset_digest,
    run_parity_cell,
)

STRUCTURES = ["hash_tree", "trie", "hash_table_trie"]
STORES = ["perfect_hash", "sorted_prefix", "hash_bucket", "bitmap",
          "packed_bitmap"]


@pytest.fixture(scope="module")
def cell_db():
    return get_dataset("T10I4D100K", scale=0.002, seed=0)


def test_itemset_digest_matches_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 17, 200):
        itemsets = {}
        for _ in range(n):
            k = int(rng.integers(1, 5))
            s = tuple(sorted(rng.choice(100, k, replace=False).tolist()))
            itemsets[s] = int(rng.integers(1, 10_000))
        assert itemset_digest(itemsets) == j_sweep.itemset_digest(itemsets)
        # order-independent: a reversed insertion order digests the same
        assert itemset_digest(dict(reversed(list(itemsets.items())))) == \
            itemset_digest(itemsets)


def test_aggregate_profiles_matches_reference():
    rows = [dict(k=1, n_candidates=40, n_frequent=30, seconds=0.5,
                 count_seconds=0.25, mapper_seconds=[0.1, 0.2]),
            dict(k=2, n_candidates=400, n_frequent=12, seconds=1.5,
                 gen_seconds=0.5, build_seconds=0.25, reduce_seconds=0.125,
                 mapper_seconds=[0.5, 0.75], inflight_depth=2,
                 inflight_retunes=1),
            dict(k=3, n_candidates=9, n_frequent=0, seconds=0.0625)]
    got = aggregate_profiles([JobProfile(**r) for r in rows])
    assert got == j_sweep.aggregate_profiles([JProfile(**r) for r in rows])
    assert aggregate_profiles([]) == j_sweep.aggregate_profiles([])


def test_parity_cell_matches_reference_digest(cell_db):
    """Every sim structure and every torch store (CPU) in one cell; the
    digest, itemset count and min count equal the reference cell's."""
    factories = {f"sim/{s}": (lambda s=s: SimRunner(structure=s, n_mappers=3))
                 for s in STRUCTURES}
    factories.update({f"torch/{s}": (lambda s=s: TorchRunner(store=s,
                                                              device="cpu"))
                      for s in STORES})
    got = run_parity_cell(cell_db, 0.02, factories)
    want = j_sweep.run_parity_cell(cell_db, 0.02, {
        "sim/trie": lambda: JSimRunner(structure="trie"),
        "jax/perfect_hash": lambda: JaxRunner(store="perfect_hash")})
    assert isinstance(got, CellResult)
    assert (got.digest, got.n_itemsets, got.min_count) == \
        (want.digest, want.n_itemsets, want.min_count)
    assert list(got.backends) == list(factories)
    for label, agg in got.backends.items():
        assert agg["n_jobs"] == want.backends["sim/trie"]["n_jobs"], label
        assert agg["n_frequent"] == want.backends["sim/trie"]["n_frequent"]
    assert got.backends["sim/trie"]["parallel_seconds"] <= \
        got.backends["sim/trie"]["sequential_seconds"] + 1e-9


class _LyingRunner(TorchRunner):
    """Reports one support off by one at level 2."""

    def count_async(self, job):
        handle = super().count_async(job)

        class Lie:
            def poll(self):
                return handle.poll()

            def result(self):
                counts, prof = handle.result()
                if job.k == 2 and counts.size:
                    counts = counts.copy()
                    counts[int(np.argmax(counts))] += 1
                return counts, prof
        return Lie()


def test_parity_cell_names_a_lying_backend(cell_db):
    with pytest.raises(AssertionError, match="liar produced"):
        run_parity_cell(cell_db, 0.02, {
            "sim/hash_table_trie":
                lambda: SimRunner(structure="hash_table_trie"),
            "liar": lambda: _LyingRunner(store="perfect_hash", device="cpu")})


def test_cell_result_schema_matches_reference():
    assert [f.name for f in dataclasses.fields(CellResult)] == \
        [f.name for f in dataclasses.fields(j_sweep.CellResult)]
