"""The plain reference against brute force and against the port's plain
CPU path, and what the benchmark's modules import (CPU)."""

from __future__ import annotations

import ast
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench import generator, harness, reference
from perfbench.tests.conftest import (
    BENCH, ROOT, SRC, STORES, TINY_CONFIGS, TINY_TRAFFIC, run_cell)


def _brute(b, item_map, cand):
    sets = [set(x) for x in b.as_lists()]
    return np.array([sum(set(item_map[c].tolist()) <= s for s in sets)
                     for c in cand], np.int64)


def test_supports_equal_brute_force():
    b = generator.quest(600, 10, 4, n_items=60, n_patterns=30, seed=9)
    ans = reference.answer(b.items, b.offsets, 60, 0.05, 3)
    assert np.array_equal(ans.hist, np.bincount(b.items, minlength=60))
    for level in ans.levels:
        assert len(level.cand)
        assert np.array_equal(level.supports,
                              _brute(b, ans.item_map, level.cand))


def test_candidates_join_and_prune():
    # every frequent pair of {0..4} but (1, 3): 3-sets holding (1, 3) go
    level = np.array([p for p in itertools.combinations(range(5), 2)
                      if p != (1, 3)])
    want = [c for c in itertools.combinations(range(5), 3)
            if not {1, 3} <= set(c)]
    assert reference.next_candidates(level, 5).tolist() == \
        [list(c) for c in want]


@pytest.mark.parametrize("seed", [1, 2])
def test_candidates_equal_the_ports_generator(seed):
    from repro_torch.core.itemsets import apriori_gen_matrix

    rng = np.random.default_rng(seed)
    for k in (1, 2, 3):
        rows = {tuple(sorted(rng.choice(40, k, replace=False)))
                for _ in range(300)}
        level = np.array(sorted(rows), np.int32)
        assert np.array_equal(reference.next_candidates(level, 40),
                              apriori_gen_matrix(level))


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("job", ["tiny-c2", "tiny-c3"])
def test_reference_equals_the_ports_cpu_path(store, job):
    """Histogram, candidates and supports, level by level, against
    ``make_runner(store, device="cpu")``."""
    from repro_torch.core.itemsets import apriori_gen_matrix
    from repro_torch.core.runtime.job import CountJob
    from repro_torch.core.runtime.runners import make_runner

    config = TINY_CONFIGS["tiny-sparse" if job == "tiny-c2" else "tiny-dense"]
    traffic = TINY_TRAFFIC[job]
    b = generator.from_config(config, seed=4, device="cpu")
    ans = reference.answer(b.items, b.offsets, b.n_items,
                           traffic["min_support"], traffic["k"])
    runner = make_runner(store=store, device="cpu")
    runner.ingest(b.as_lists())
    hist, _ = runner.job1()
    assert np.array_equal(hist, ans.hist[:len(hist)])
    assert not ans.hist[len(hist):].any()
    item_map = np.flatnonzero(hist >= ans.min_count)
    assert np.array_equal(item_map, ans.item_map)
    runner.place(item_map)
    level = np.arange(len(item_map), dtype=np.int32)[:, None]
    for want in ans.levels:
        cand = apriori_gen_matrix(level)
        assert np.array_equal(cand, want.cand)
        counts, _ = runner.count(CountJob(want.k, cand, ans.min_count))
        assert np.array_equal(counts, want.supports)
        level = cand[counts >= ans.min_count]
    assert len(ans.levels[-1].cand) > 0


@pytest.mark.parametrize("store", STORES)
def test_a_small_run_is_correct_on_every_store(tiny_root, store):
    for job in ("tiny-c2", "tiny-c3"):
        rc, line = run_cell(tiny_root, f"{job}-{store}")
        assert rc == 0 and line["correct"], line
        assert all(c["value"] == 0 for c in line["checks"].values())


PURE = ("generator.py", "reference.py", "roofline.py", "devtrace.py")
ALLOWED = {"__future__", "collections", "dataclasses", "gc", "heapq",
           "math", "typing", "numpy", "torch", "perfbench"}


@pytest.mark.parametrize("name", PURE)
def test_yardstick_modules_import_nothing_of_the_program(name):
    tree = ast.parse((BENCH / name).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= ALLOWED, tops - ALLOWED


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": f"{ROOT}:{SRC}"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_reference_loads_no_program():
    tops = _modules_after("import perfbench.reference, perfbench.generator")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_whole_run_loads_neither_jax_nor_repro(tmp_path):
    """Everything ``run.py`` imports, the kind, every reader and a whole
    small run on the CPU: no module whose top-level name is forbidden."""
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from perfbench.tests.conftest import make_root, run_cell\n"
        f"root = make_root(Path({str(tmp_path)!r}))\n"
        "rc, line = run_cell(root, 'tiny-c3-packed_bitmap', trace=1)\n"
        "assert rc == 0 and line['correct'], line\n")
    tops = _modules_after(code)
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.forbidden_modules()
