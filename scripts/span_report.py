"""Where one benchmark cell's host time goes, by the program's own spans.

    python3 scripts/span_report.py --workload t40i10-c3-bitmap --seed 7 \
        [--trace 1] [--root DIR] [--out FILE]

Runs one cell of ``BENCHMARK.json`` once through the benchmark's harness,
in this process, as ``perfbench/run.py`` does, from the checkout at
``--root`` (default: this one), and watches every count job of the
program's runner: its wall seconds, its ``JobProfile``, whether a
profiler recorded, and the seconds and calls that each span of
``repro_torch.trace`` gained in it (none where the program has no such
module).  Prints one JSON object, and writes it to ``--out``: the
harness's result line, every job, the means over the window's jobs (with
``--trace 1`` the untraced jobs and the traced ones apart, and the traced
window's longest idle gaps with the host events around each), and the
host cost of one span with no profiler running.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import timeit
from pathlib import Path

T_START = time.perf_counter()
JOB_SPANS = ("repro_torch.engine.encode", "repro_torch.engine.launch",
             "repro_torch.engine.wait")


def _totals():
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return {}
    got = trace.totals()
    return {n: (s, got["calls"][n]) for n, s in got["seconds"].items()}


def _watch(runner_cls, jobs):
    """Wrap ``runner_cls.count`` to append one record a job to ``jobs``."""
    import torch

    count = runner_cls.count

    def watched(self, job):
        traced = torch.autograd._profiler_enabled()
        before = _totals()
        t0 = time.perf_counter()
        counts, prof = count(self, job)
        wall = time.perf_counter() - t0
        after = _totals()
        spans = {n: [s - before.get(n, (0.0, 0))[0],
                     c - before.get(n, (0.0, 0))[1]]
                 for n, (s, c) in after.items()
                 if c != before.get(n, (0.0, 0))[1]}
        jobs.append({"k": job.k, "traced": traced, "wall": wall,
                     "seconds": prof.seconds,
                     "encode_seconds": prof.encode_seconds, "spans": spans})
        return counts, prof

    runner_cls.count = watched


def _means(jobs):
    if not jobs:
        return None
    out = {key: sum(j[key] for j in jobs) / len(jobs)
           for key in ("wall", "seconds", "encode_seconds")}
    for name in JOB_SPANS:
        out[name] = sum(j["spans"].get(name, [0.0, 0])[0]
                        for j in jobs) / len(jobs)
        out[name + ".calls"] = sum(j["spans"].get(name, [0.0, 0])[1]
                                   for j in jobs) / len(jobs)
    covered = sum(out[name] for name in JOB_SPANS)
    out["spans_over_seconds"] = covered / out["seconds"]
    out["jobs"] = len(jobs)
    return out


def _watch_trace(devtrace, seen):
    """Wrap ``devtrace.breakdown`` to keep the traced window's events."""
    breakdown = devtrace.breakdown

    def kept(device, host, lo, hi):
        seen.update(device=device, host=host, lo=lo, hi=hi)
        return breakdown(device, host, lo, hi)

    devtrace.breakdown = kept


def _longest_gaps(devtrace, seen, top=25, during=16):
    """The traced window's longest idle gaps: each one's seconds, its start
    from the start of its job, every host event covering its middle
    (outermost first), and the first host events that start inside it
    (name, start from the gap's start, seconds)."""
    if not seen:
        return None
    host = seen["host"]
    jobs = sorted(s for name, s, _ in host if name == devtrace.JOB)
    gaps = sorted(devtrace.gaps(seen["device"], seen["lo"], seen["hi"]),
                  key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        stack = sorted((hs, name) for name, hs, he in host if hs <= mid <= he)
        start = max((j for j in jobs if j <= s), default=seen["lo"])
        inside = sorted((hs - s, name, he - hs) for name, hs, he in host
                        if s <= hs < e)[:during]
        out.append([e - s, s - start, [name for _, name in stack],
                    [[name, at, dur] for at, name, dur in inside]])
    return out


def _span_cost(n=200_000):
    """Seconds a span with no profiler running, less an empty call."""
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return None

    def one():
        with trace.span("span_report.cost"):
            pass

    def empty():
        pass

    best = min(timeit.repeat(one, number=n, repeat=5)) / n
    base = min(timeit.repeat(empty, number=n, repeat=5)) / n
    return best - base


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--out")
    p.add_argument("--device", default="cuda",
                   help="cpu: a small configuration without a card")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[0:0] = [root, os.path.join(root, "src")]
    sys.pycache_prefix = os.path.join(root, "build", "perfbench", "pycache")
    sys.dont_write_bytecode = False
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
        root, "build", "perfbench", "extensions"))
    from perfbench import devtrace, harness
    from repro_torch.core.runtime.runners import TorchRunner

    jobs, seen = [], {}
    _watch(TorchRunner, jobs)
    _watch_trace(devtrace, seen)
    lines = []
    rc = harness.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace",
                       str(args.trace)], root=root, t_start=T_START,
                      device=args.device,
                      require_cards=args.device == "cuda", out=lines.append)
    if rc or not lines:
        return rc or 1
    line = json.loads(lines[-1])
    traffic = harness.resolve(Path(root), args.workload)[3]
    window = jobs[int(traffic["k"]) - 1:]  # after lower levels and warm-up
    report = {"workload": args.workload, "seed": args.seed, "root": root,
              "line": line, "jobs": jobs,
              "untraced": _means([j for j in window if not j["traced"]]),
              "traced": _means([j for j in window if j["traced"]]),
              "setup_spans": {n: v for n, v in _totals().items()
                              if n not in JOB_SPANS},
              "gaps": _longest_gaps(devtrace, seen),
              "span_cost_s": _span_cost()}
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
