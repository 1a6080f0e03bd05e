"""The benchmark's harness: find a cell by name, run it, print its result.

Everything that belongs to one cell lives in files of its own, found by the
names in ``BENCHMARK.json``:

- a configuration: the ``file`` its entry names (``configs/<name>.json``),
  the sizes and the guarantee of one deployment;
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the code
  that drives it, ``kinds/<kind>.py`` (a ``run(cell) -> Outcome``);
- a per-layer metric: ``metrics/<name>.py``, a ``read(readings)`` that
  returns a number, or ``None`` when its run had nothing to read.

A run prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``, every number that
decided ``correct`` beside its limit; the same numbers are the last lines
of its standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: spans and counters of the run, and
    the device trace of its traced jobs."""

    spans: Dict[str, float]            # set-up spans by name, seconds
    shape: Dict[str, int]              # the job's sizes (rows, cands, ...)
    # per untraced job: the engine's dispatch and the kernels' launches
    encode_seconds: List[float] = dataclasses.field(default_factory=list)
    launches: List[int] = dataclasses.field(default_factory=list)
    traced_jobs: int = 0               # jobs inside the traced window
    window: tuple = (0.0, 0.0)         # its bounds on the trace's clock
    device_events: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, tuple]           # name -> (value, limit)
    readings: Readings
    device: dict
    breakdown: Optional[dict] = None

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and all(
            v <= limit for v, limit in self.checks.values())


@dataclasses.dataclass
class Cell:
    """One run of one cell, as the kind's ``run`` gets it."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    chips: int = 1
    # seconds of the harness's own steps before the kind's run, by name
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(entry: dict, cell: str) -> bool:
    """A metric without ``workloads`` is every cell's."""
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def missing_cards(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "CUDA is not available"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} are visible")
    return None


def read_metrics(entries: List[dict], cell: str, readers_dir: Path,
                 readings: Readings) -> dict:
    out = {}
    for entry in entries:
        if not applies(entry, cell):
            continue
        reader = load_module(readers_dir / f"{entry['name']}.py",
                             f"perfbench_metric_{len(out)}")
        value = reader.read(readings)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def result(spec: dict, cell: str, trace: bool, outcome: Outcome,
           readers_dir: Path) -> dict:
    if trace:
        metrics = read_metrics(spec["per_layer"], cell, readers_dir,
                               outcome.readings)
    else:
        metrics = {e["name"]: {"value": outcome.end_to_end[e["name"]],
                               "unit": e["unit"]}
                   for e in spec["end_to_end"] if applies(e, cell)}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": outcome.device}
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {name: {"value": v, "limit": limit}
                      for name, (v, limit) in outcome.checks.items()}
    return line


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def resolve(root: Path, workload: str):
    """(spec, cell entry, configuration, traffic, kind module) of
    ``workload``, or ``None`` when BENCHMARK.json at ``root`` has no such
    cell."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        return None
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    bench = root / spec["paths"][0]
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    kind = load_module(bench / "kinds" / f"{traffic['kind']}.py",
                       f"perfbench_kind_{traffic['kind']}")
    return spec, entry, config, traffic, kind


def main(argv: List[str], root: Path, t_start: float,
         device: str = "cuda", require_cards: bool = True,
         out: Callable[[str], None] = print) -> int:
    """Run the cell ``argv`` names from the checkout at ``root``.  Tests
    pass ``device="cpu"`` and ``require_cards=False`` to drive the rest of
    a run without a card."""
    args = parse(argv)
    root = Path(root)
    t = time.perf_counter()
    marks = {"harness": t - t_start}
    found = resolve(root, args.workload)  # imports torch with the kind
    if found is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    spec, entry, config, traffic, kind = found
    marks["imports"] = time.perf_counter() - t
    if require_cards:
        t = time.perf_counter()
        why = missing_cards(int(entry["chips"]))
        if why:
            print(f"no run: {why}", file=sys.stderr)
            return 3
        marks["card query"] = time.perf_counter() - t
    src = root / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    outcome = kind.run(Cell(
        name=args.workload, config=config, traffic=traffic, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=t_start, chips=int(entry["chips"]), marks=marks))
    loaded = forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 4
    line = result(spec, args.workload, bool(args.trace), outcome,
                  root / spec["paths"][0] / "metrics")
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    out(json.dumps(line))
    return 0
