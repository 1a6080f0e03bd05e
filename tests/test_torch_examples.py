"""PyTorch port vs JAX package: ``examples/mappers_scaling_torch.py``, the
twin of ``examples/mappers_scaling.py`` (the paper's speedup against the
number of mappers), at a small scale: every cell's itemsets AND supports
equal across the three structures and mapper counts, and equal to the
reference's ``run_mapreduce_apriori`` on the same database."""

import importlib.util
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import run_mapreduce_apriori as j_run  # noqa: E402
from repro.data import quest_generator as j_quest  # noqa: E402

from repro_torch.data import quest_generator  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "mappers_scaling_torch.py")
# At this scale 0.014 is the highest support that keeps pairs (two), so
# the second job's counts reach the answer; the example's 0.02 keeps
# singletons only, and the table is held at it.
SCALE, MIN_SUPPORT = 0.005, 0.014


def _example():
    spec = importlib.util.spec_from_file_location("mappers_scaling_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _db(gen):
    return gen(n_transactions=int(100_000 * SCALE), avg_transaction_len=10,
               n_items=1000, seed=42)


def test_mappers_scaling_cells_equal_the_reference():
    db = _db(quest_generator)
    assert db == _db(j_quest)
    runs = _example().scaling_runs(db, MIN_SUPPORT, mappers=(1, 5))
    assert sorted(runs) == sorted((s, m) for s in
                                  ("hash_tree", "trie", "hash_table_trie")
                                  for m in (1, 5))
    want = j_run(db, MIN_SUPPORT, structure="hash_table_trie",
                 n_mappers=5).itemsets
    assert len(want) > 100 and any(len(i) >= 2 for i in want)
    for key, res in runs.items():
        assert res.itemsets == want, key
        assert res.n_mappers == key[1] and res.structure == key[0]
        assert res.parallel_seconds > 0


def test_mappers_scaling_example_prints_the_table():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, EXAMPLE, "--scale", str(SCALE)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == f"{int(100_000 * SCALE)} transactions, min_support=0.02"
    rows = [line for line in lines if "|" in line]
    assert rows[0].split("|")[0].strip() == "mappers"
    assert [int(r.split("|")[0]) for r in rows[1:]] == [1, 2, 5, 10, 20]
    assert "equal in every cell" in out.stdout
