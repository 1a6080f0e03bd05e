"""The benchmark's vectorised Quest generator (CPU)."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import generator, reference


def test_a_seed_gives_the_same_baskets():
    a = generator.quest(3000, 10, 4, seed=2**31 + 17)
    b = generator.quest(3000, 10, 4, seed=2**31 + 17)
    c = generator.quest(3000, 10, 4, seed=2**31 + 18)
    assert np.array_equal(a.items, b.items)
    assert np.array_equal(a.offsets, b.offsets)
    assert not (len(a.items) == len(c.items)
                and np.array_equal(a.items, c.items))


@pytest.mark.parametrize("seed", [0, -5, 2**40 + 3])
def test_baskets_are_sorted_distinct_and_in_range(seed):
    b = generator.quest(2000, 10, 4, n_items=300, n_patterns=200, seed=seed)
    lengths = b.lengths()
    assert b.n_baskets == 2000 and lengths.min() >= 1
    assert b.items.min() >= 0 and b.items.max() < 300
    for basket in b.as_lists()[:200]:
        assert basket == sorted(set(basket))


@pytest.mark.parametrize("t, i", [(10, 4), (40, 10)])
def test_mean_basket_length_is_about_t(t, i):
    # Patterns are added whole, so a basket ends at or somewhat past its
    # drawn length (at most 1.5 times it): the mean lies a little above T.
    b = generator.quest(20_000, t, i, seed=3)
    mean = float(b.lengths().mean())
    assert t <= mean <= 1.1 * t


# Lattice sizes (F1, C2, F2, C3) at each cell's support on 20,000 baskets,
# seed 0, drawn on the CPU.  The port's own generator gives (946, 446,985,
# 989, 947) and (1,000, 499,500, 13,231, 70,053) on the same sizes.
LATTICE = {(10, 4, 0.0025): (947, 447_931, 1_003, 951),
           (40, 10, 0.005): (999, 498_501, 13_110, 70_079)}


@pytest.mark.parametrize("t, i, support", sorted(LATTICE))
def test_lattice_sizes_on_a_small_database(t, i, support):
    b = generator.quest(20_000, t, i, seed=0)
    ans = reference.answer(b.items, b.offsets, b.n_items, support, 2)
    c2 = ans.levels[0]
    f2 = c2.cand[c2.supports >= ans.min_count]
    c3 = reference.next_candidates(f2, len(ans.item_map))
    assert (len(ans.item_map), len(c2.cand), len(f2), len(c3)) \
        == LATTICE[(t, i, support)]


def test_every_seed_counts_the_same_lattice():
    """Seeds shuffle one database: other baskets in each row, other item
    ids, the same sizes level by level."""
    kw = dict(n_transactions=3000, avg_transaction_len=10,
              avg_pattern_len=4, n_items=200, n_patterns=100)
    a = generator.quest(seed=1, **kw)
    b = generator.quest(seed=2, **kw)
    assert not np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(np.sort(a.lengths()), np.sort(b.lengths()))
    ha, hb = np.bincount(a.items, minlength=200), np.bincount(
        b.items, minlength=200)
    assert not np.array_equal(ha, hb)
    assert np.array_equal(np.sort(ha), np.sort(hb))
    sizes = []
    for x in (a, b):
        ans = reference.answer(x.items, x.offsets, 200, 0.02, 3)
        sizes.append([len(ans.item_map)] + [
            (len(lv.cand), int((lv.supports >= ans.min_count).sum()))
            for lv in ans.levels])
    assert sizes[0] == sizes[1]
    assert sizes[0][2][0] > 0
