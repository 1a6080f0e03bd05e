"""PyTorch port vs JAX package: candidate generation and the SPC cut-back.

Counts and candidate matrices are integers, so every comparison is exact,
row order included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import itemsets as J  # noqa: E402
from repro.core.runtime.device_loop import (  # noqa: E402
    filter_candidates_device as j_filter_device,
)

from repro_torch.core import itemsets as T  # noqa: E402
from repro_torch.core.runtime import device_loop as T_dl  # noqa: E402


def _level(rng, k, n_items, n_rows):
    rows = {tuple(sorted(rng.choice(n_items, k, replace=False).tolist()))
            for _ in range(n_rows)}
    return J.level_to_matrix(sorted(rows))


@pytest.mark.parametrize("seed", range(8))
def test_apriori_gen_matrix_parity(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 5))
    mat = _level(rng, k, int(rng.integers(k + 1, 24)), int(rng.integers(1, 80)))
    want = J.apriori_gen_matrix(mat)
    got = T.apriori_gen_matrix(mat)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert T.matrix_to_level(got) == J.apriori_gen(J.matrix_to_level(mat))


@pytest.mark.parametrize("seed", range(6))
def test_filter_and_rows_member_parity(seed):
    """A speculative superset (generated from the level) cut back to the
    rows whose every subset survived a random threshold."""
    rng = np.random.default_rng(100 + seed)
    k = int(rng.integers(1, 4))
    level = _level(rng, k, int(rng.integers(k + 2, 20)), 60)
    spec = J.apriori_gen_matrix(level)
    freq = level[rng.random(level.shape[0]) < 0.7]
    want = J.filter_candidates_matrix(spec, freq)
    np.testing.assert_array_equal(T.filter_candidates_matrix(spec, freq), want)
    np.testing.assert_array_equal(j_filter_device(spec, freq), want)
    np.testing.assert_array_equal(
        T_dl.filter_candidates_device(spec, freq, device="cpu"), want)
    queries = spec[:, 1:] if spec.size else spec
    np.testing.assert_array_equal(T._rows_member(freq, queries),
                                  J._rows_member(freq, queries))


def test_filter_device_chunks_queries(monkeypatch):
    """A tiny bound on the (Q, L) intermediate forces many query chunks; the
    rows and their order stay the same."""
    rng = np.random.default_rng(7)
    level = _level(rng, 2, 30, 200)
    spec = J.apriori_gen_matrix(level)
    freq = level[rng.random(level.shape[0]) < 0.8]
    monkeypatch.setattr(T_dl, "_MAX_EQ_ELEMENTS", 3 * freq.shape[0])
    np.testing.assert_array_equal(
        T_dl.filter_candidates_device(spec, freq, device="cpu"),
        J.filter_candidates_matrix(spec, freq))


def test_empty_inputs_and_level_round_trip():
    empty = np.zeros((0, 2), np.int32)
    assert T.apriori_gen_matrix(empty).shape == J.apriori_gen_matrix(empty).shape
    assert T.filter_candidates_matrix(empty, empty).shape == (0, 2)
    assert T_dl.filter_candidates_device(empty, empty, device="cpu").shape == (0, 2)
    level = [(3, 1), (0, 2), (1, 3)]
    np.testing.assert_array_equal(T.level_to_matrix(level),
                                  J.level_to_matrix(level))
    assert T.matrix_to_level(T.level_to_matrix(level)) == T.sort_level(level)


def test_brute_force_oracles_agree():
    rng = np.random.default_rng(3)
    db = [sorted(set(rng.integers(0, 12, int(rng.integers(0, 7))).tolist()))
          for _ in range(60)]
    assert T.brute_force_frequent(db, 6) == J.brute_force_frequent(db, 6)
