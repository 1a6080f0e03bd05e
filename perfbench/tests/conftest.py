"""Fixtures of the benchmark's tests: a checkout in a temporary directory
with the benchmark's files and two small cells of its own."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# Small configurations the CPU runs in seconds; each keeps its cell's kind
# of job (a level-2 job over sparse baskets, a level-3 job over dense ones).
TINY_CONFIGS = {
    "tiny-sparse": {"n_transactions": 3000, "avg_transaction_len": 10,
                    "avg_pattern_len": 4, "n_items": 200, "n_patterns": 100,
                    "corruption_mean": 0.5, "corruption_sd": 0.1},
    "tiny-dense": {"n_transactions": 2000, "avg_transaction_len": 20,
                   "avg_pattern_len": 6, "n_items": 150, "n_patterns": 60,
                   "corruption_mean": 0.5, "corruption_sd": 0.1},
}
TINY_TRAFFIC = {
    "tiny-c2": {"kind": "count_job", "k": 2, "min_support": 0.02,
                "trace_jobs": 2},
    "tiny-c3": {"kind": "count_job", "k": 3, "min_support": 0.03,
                "trace_jobs": 2},
}
STORES = ("packed_bitmap", "bitmap", "perfect_hash")


def tiny_cells():
    """(cell, config, job, store) of every small cell; each cell's traffic
    file has the cell's name."""
    return [(f"{job}-{store}", config, job, store) for store in STORES
            for job, config in (("tiny-c2", "tiny-sparse"),
                                ("tiny-c3", "tiny-dense"))]


def make_root(tmp: Path) -> Path:
    """A checkout at ``tmp``: the benchmark's files and BENCHMARK.json,
    with the small cells added by files and entries only."""
    shutil.copytree(BENCH, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, sizes in TINY_CONFIGS.items():
        (tmp / "perfbench" / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, **sizes}))
        spec["configs"].append({
            "name": name, "source": "a small configuration of the tests",
            "file": f"perfbench/configs/{name}.json", "reduced": [],
            "why": "tests"})
    for cell, config, job, store in tiny_cells():
        (tmp / "perfbench" / "traffic" / f"{cell}.json").write_text(
            json.dumps({**TINY_TRAFFIC[job], "store": store}))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": cell, "chips": 1,
                                  "why": "tests"})
    for metric in spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] += [c[0] for c in tiny_cells()]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def run_cell(root: Path, cell: str, seed: int = 11, trace: int = 0,
             seconds: float = 0.2, device: str = "cpu"):
    """Drive one run of ``cell`` through the harness without looking for a
    card; returns (exit code, result line or None)."""
    from perfbench import harness

    lines = []
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      t_start=time.perf_counter(), device=device,
                      require_cards=device == "cuda", out=lines.append)
    return rc, (json.loads(lines[-1]) if lines else None)
