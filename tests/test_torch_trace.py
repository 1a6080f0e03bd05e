"""The port's host spans (``repro_torch.trace``): totals kept on every
call, the profiler's range entered only while a profiler records, and the
nine spans of the runner and the engine recorded once a phase or once a
candidate chunk, never once a row block (CPU)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_stores import one_torch_thread  # noqa: E402,F401

from repro_torch import trace  # noqa: E402
from repro_torch.core.itemsets import apriori_gen_matrix  # noqa: E402
from repro_torch.core.runtime.job import CountJob  # noqa: E402
from repro_torch.core.runtime.runners import TorchRunner  # noqa: E402

SETUP = ("repro_torch.ingest.rows", "repro_torch.ingest.fill",
         "repro_torch.runner.job1", "repro_torch.runner.place.encode",
         "repro_torch.engine.place.copy", "repro_torch.engine.place.pack")
JOB = ("repro_torch.engine.encode", "repro_torch.engine.launch",
       "repro_torch.engine.wait")
STORES = ("perfect_hash", "packed_bitmap", "bitmap")
N_ITEMS, N_ROWS, BLOCK_N, CAND_BLOCK = 30, 400, 16, 150


@pytest.fixture(autouse=True)
def fresh_totals():
    trace.reset()
    yield
    trace.reset()


def _baskets(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N_ITEMS, int(rng.integers(0, 10))).tolist()
            for _ in range(N_ROWS)]


def _set_up(store):
    runner = TorchRunner(store=store, block_n=BLOCK_N, cand_block=CAND_BLOCK,
                         device="cpu")
    runner.ingest(_baskets())
    hist, _ = runner.job1()
    item_map = np.flatnonzero(hist > 0)
    runner.place(item_map)
    cand = apriori_gen_matrix(
        np.arange(len(item_map), dtype=np.int32)[:, None])
    assert 2 * CAND_BLOCK < len(cand) <= 3 * CAND_BLOCK  # three chunks
    return runner, cand, item_map


def _brute(cand, item_map):
    sets = [set(b) for b in _baskets()]
    items = item_map[cand]
    return np.array([sum(set(row.tolist()) <= s for s in sets)
                     for row in items], np.int64)


def test_span_adds_seconds_and_calls():
    for _ in range(2):
        with trace.span("t.sleep"):
            time.sleep(0.01)
    with trace.span("t.other"):
        pass
    got = trace.totals()
    assert got["calls"] == {"t.sleep": 2, "t.other": 1}
    assert got["seconds"]["t.sleep"] >= 0.02
    assert 0 <= got["seconds"]["t.other"] < got["seconds"]["t.sleep"]
    got["calls"]["t.sleep"] = 99  # a snapshot: the totals do not move
    assert trace.totals()["calls"]["t.sleep"] == 2


def test_span_counts_a_block_that_raises():
    with pytest.raises(ValueError):
        with trace.span("t.raises"):
            raise ValueError("boom")
    assert trace.totals()["calls"] == {"t.raises": 1}


@pytest.mark.parametrize("store", STORES)
def test_no_profiler_no_record_function(store, monkeypatch):
    """Without a profiler no span enters ``record_function``: set-up and a
    job run with it made to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    runner, cand, _ = _set_up(store)
    runner.count(CountJob(2, cand))
    assert set(trace.totals()["calls"]) == set(SETUP + JOB)


@pytest.mark.parametrize("store", STORES)
def test_setup_spans_once_and_job_spans_once_a_chunk(store):
    runner, cand, item_map = _set_up(store)
    calls = trace.totals()["calls"]
    assert calls == {name: 1 for name in SETUP}
    t0 = time.perf_counter()
    counts, prof = runner.count(CountJob(2, cand))
    wall = time.perf_counter() - t0
    got = trace.totals()
    # three chunks of N_ROWS / BLOCK_N = 25 row blocks each: one span a chunk
    assert {n: got["calls"][n] for n in JOB} == {n: 3 for n in JOB}
    assert {n: got["calls"][n] for n in SETUP} == {n: 1 for n in SETUP}
    assert sum(got["seconds"][n] for n in JOB) <= wall
    assert prof.seconds <= wall
    np.testing.assert_array_equal(counts, _brute(cand, item_map))


def _annotations(prof):
    """(name, start_s, end_s) of the profile's host user annotations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return sorted(out, key=lambda x: x[1])


@pytest.mark.parametrize("store", STORES)
def test_spans_are_profiler_annotations_where_the_table_puts_them(store):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("t.setup"):
            runner, cand, _ = _set_up(store)
        with torch.profiler.record_function("t.job"):
            runner.count(CountJob(2, cand))
    spans = _annotations(prof)
    named = {}
    for name, s, e in spans:
        named.setdefault(name, []).append((s, e))
    assert {n: len(named.get(n, ())) for n in SETUP} == {n: 1 for n in SETUP}
    assert {n: len(named.get(n, ())) for n in JOB} == {n: 3 for n in JOB}
    (setup,), (job,) = named["t.setup"], named["t.job"]
    for names, (lo, hi) in ((SETUP, setup), (JOB, job)):
        for name in names:
            assert all(lo <= s <= e <= hi for s, e in named[name]), name
    # the set-up phases in order, none inside another
    firsts = [named[n][0] for n in SETUP]
    assert all(a[1] <= b[0] for a, b in zip(firsts, firsts[1:]))
    # a chunk's encode, launch and wait are leaves: none lies in another
    leaves = sorted(iv for n in JOB for iv in named[n])
    assert all(a[1] <= b[0] for a, b in zip(leaves, leaves[1:]))
    # the totals count the traced calls too
    assert trace.totals()["calls"]["repro_torch.engine.launch"] == 3


@pytest.mark.parametrize("store", STORES)
def test_counts_equal_with_and_without_a_profiler(store):
    runner, cand, item_map = _set_up(store)
    plain, _ = runner.count(CountJob(2, cand))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        traced, _ = runner.count(CountJob(2, cand))
    np.testing.assert_array_equal(plain, traced)
    np.testing.assert_array_equal(plain, _brute(cand, item_map))
