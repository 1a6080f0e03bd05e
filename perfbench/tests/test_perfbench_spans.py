"""The readers of the program's set-up spans (``perfbench/spans.py``), on
spans recorded by hand and through the harness, and what they give on a
program without the spans (CPU)."""

from __future__ import annotations

import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import BENCH, run_cell

trace = pytest.importorskip("repro_torch.trace")

SPANS = {"ingest_rows_s": "repro_torch.ingest.rows",
         "ingest_fill_s": "repro_torch.ingest.fill",
         "job1_s": "repro_torch.runner.job1",
         "place_encode_s": "repro_torch.runner.place.encode",
         "place_pack_s": "repro_torch.engine.place.pack",
         "place_copy_s": "repro_torch.engine.place.copy"}


@pytest.fixture(autouse=True)
def fresh_totals():
    trace.reset()
    yield
    trace.reset()


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"test_span_reader_{name}")


def readings():
    return harness.Readings(spans={}, shape={"rows": 8, "cands": 4,
                                             "items": 3, "k": 2})


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_reader_gives_its_spans_seconds_a_call(metric, monkeypatch):
    assert reader(metric).read(readings()) is None  # nothing recorded
    # two calls of 0.25 s and 0.75 s, then another span's 7 s
    clock = iter([1.0, 1.25, 2.0, 2.75, 3.0, 10.0])
    monkeypatch.setattr(trace.time, "perf_counter", lambda: next(clock))
    for _ in range(2):
        with trace.span(SPANS[metric]):
            pass
    with trace.span("repro_torch.something.else"):
        pass
    monkeypatch.undo()
    assert reader(metric).read(readings()) == pytest.approx(0.5)


def test_a_span_that_raised_still_counts(monkeypatch):
    clock = iter([0.0, 0.5])
    monkeypatch.setattr(trace.time, "perf_counter", lambda: next(clock))
    with pytest.raises(KeyError):
        with trace.span(SPANS["job1_s"]):
            raise KeyError("job1")
    monkeypatch.undo()
    assert reader("job1_s").read(readings()) == pytest.approx(0.5)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_program_without_spans_gives_nothing(metric, monkeypatch):
    with trace.span(SPANS[metric]):
        pass
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert reader(metric).read(readings()) is None


@pytest.mark.parametrize("cell", ["tiny-c2-packed_bitmap",
                                  "tiny-c3-perfect_hash", "tiny-c3-bitmap"])
def test_a_traced_run_reports_the_six_set_up_spans(tiny_root, cell):
    rc, line = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and line["correct"], line
    got = {name: line["metrics"][name]["value"] for name in SPANS}
    assert all(v > 0 for v in got.values()), got
    assert all(line["metrics"][name]["unit"] == "s" for name in SPANS)
    # the spans lie inside the benchmark's own spans around the calls
    metrics = {name: m["value"] for name, m in line["metrics"].items()}
    assert got["ingest_rows_s"] + got["ingest_fill_s"] <= metrics["ingest_s"]
    assert (got["job1_s"] + got["place_encode_s"] + got["place_pack_s"]
            + got["place_copy_s"]) <= metrics["place_s"]
    rc, line = run_cell(tiny_root, cell, trace=0)
    assert rc == 0 and set(line["metrics"]) == {"count_job_s", "setup_s"}


def test_a_traced_run_of_a_program_without_spans_leaves_them_out(
        tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    rc, line = run_cell(tiny_root, "tiny-c2-perfect_hash", trace=1)
    assert rc == 0 and line["correct"], line
    assert not set(SPANS) & set(line["metrics"])
    assert {"ingest_s", "place_s", "dispatch_s"} <= set(line["metrics"])
