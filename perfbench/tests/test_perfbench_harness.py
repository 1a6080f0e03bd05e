"""The harness: cells and metrics found by name, the result line, the
contract of BENCHMARK.json, and the runs that must print no result (CPU)."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import BENCH, ROOT, SRC, run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_and_a_metric_added_by_files_only(tiny_root):
    """A new configuration, traffic mix, cell and per-layer metric: files
    under the benchmark's folder and entries in BENCHMARK.json, no code
    edited."""
    bench = tiny_root / "perfbench"
    (bench / "configs" / "dummy.json").write_text(json.dumps({
        "n_transactions": 1500, "avg_transaction_len": 8,
        "avg_pattern_len": 3, "n_items": 120, "n_patterns": 50,
        "corruption_mean": 0.4, "corruption_sd": 0.1}))
    (bench / "traffic" / "dummy-c2.json").write_text(json.dumps({
        "kind": "count_job", "k": 2, "min_support": 0.03,
        "store": "perfect_hash", "trace_jobs": 1}))
    (bench / "metrics" / "dummy_cands.py").write_text(
        "def read(r):\n    return float(r.shape['cands'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "tests",
                            "file": "perfbench/configs/dummy.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy",
                              "traffic": "dummy-c2", "chips": 1,
                              "why": "tests"})
    spec["per_layer"].append({"name": "dummy_cands", "unit": "rows",
                              "better": "lower", "source": "program_counter",
                              "layer": "engine", "moves": "count_job_s",
                              "workloads": ["dummy-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = run_cell(tiny_root, "dummy-cell", trace=1)
    assert rc == 0 and line["correct"], line
    assert line["metrics"]["dummy_cands"]["value"] > 0
    rc, line = run_cell(tiny_root, "dummy-cell", trace=0)
    assert rc == 0 and set(line["metrics"]) == {"count_job_s", "setup_s"}


def test_the_result_line(tiny_root, capsys):
    rc, line = run_cell(tiny_root, "tiny-c2-packed_bitmap", seed=2**31 + 9)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    for metric in line["metrics"].values():
        assert metric["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    err = capsys.readouterr().err.strip().splitlines()
    checks = [f"check {n} {c['value']} limit {c['limit']}"
              for n, c in line["checks"].items()]
    assert err[-len(checks):] == checks
    rc, line = run_cell(tiny_root, "tiny-c2-packed_bitmap", trace=1)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_no_card_no_result(tiny_root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this test needs a machine without")
    lines = []
    rc = harness.main(["--workload", "tiny-c2-perfect_hash", "--seed", "1",
                       "--seconds", "1"], root=tiny_root, t_start=0.0,
                      out=lines.append)
    assert rc != 0 and not lines


def test_only_the_benchmarks_files_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    (no program) exits with another code than 0 and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "t10i4-c2-hash",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs of rs + 60 s, 2 x 90
    # s of compiles a cell and 1,200 s spare, in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        assert set(c["reduced"]) <= set(data)
        assert set(c["reduced"]) <= set(data["published"])
        assert all(data[k] != data["published"][k] for k in c["reduced"])
        assert data["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"] if harness.applies(m, cell)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(harness.applies(m, cell) for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_each_job_of_a_window_gets_a_fresh_copy_of_its_candidates():
    import numpy as np
    from repro_torch.core.runtime.job import CountJob

    kind = harness.load_module(BENCH / "kinds" / "count_job.py",
                               "test_kind_count_job")
    job = CountJob(2, np.arange(6, dtype=np.int32).reshape(3, 2), 5)
    new = kind.fresh(job)
    assert new is not job and not np.shares_memory(new.cand, job.cand)
    assert np.array_equal(new.cand, job.cand)
    assert (new.k, new.min_count) == (job.k, job.min_count)
