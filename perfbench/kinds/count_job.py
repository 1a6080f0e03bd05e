"""Traffic kind ``count_job``: one Apriori level's support-counting job,
run back to back over a database that set-up made resident.

This is the paper's K-ItemsetMapper job on the Hadoop model: the data is
loaded once, and each level is one job over it.  The traffic file gives
the job: ``k`` (its level), ``min_support``, ``store`` (the program's data
structure) and ``trace_jobs`` (jobs read, then traced, by ``--trace 1``).

Set-up, in order: the baskets from the seed (``generator.py``); the
program's runner with its own defaults; ``ingest``, ``job1`` and ``place``
over the items of support ``ceil(s N)`` or more; the candidates of level 2
from the port's ``apriori_gen_matrix`` and, up to level k, each level's
job run once, its frequent rows kept and joined to the next level; one
warm-up of the timed job.  The window then runs the timed job back to back
until the first job that ends after ``--seconds``.  Every job repeats the
same candidates, but each gets a job of its own over a fresh copy of them,
as each level of a mine hands the runner new arrays: nothing the program
could key on an array's identity carries from one job to the next.  The
resident database is the same in every job, as in a mine.

Once the window has closed and the program's state is freed, the plain
reference (``reference.py``) works out the histogram, the frequent items,
every level's candidates and every support again from the baskets, and the
run is correct only if the program's histogram, its item map, the job's
candidate matrix and every support of every job in the window equal it.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from perfbench import devtrace, generator, reference
from perfbench.harness import Outcome, Readings

# Each compared number and its limit: counts are integers and every one is
# stated exact, so every limit is 0 (see PERF.md for the readings).
LIMITS = {"hist_diff": 0, "item_map_diff": 0, "cand_diff": 0,
          "support_err": 0, "jobs_wrong": 0}


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "power limit not read"
    return f"{name}, {limit}"


def _rows_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Rows of two matrices (or entries of two vectors) that differ, plus
    the difference of their lengths; every row when the widths differ."""
    n = min(len(a), len(b))
    extra = abs(len(a) - len(b))
    if a.ndim != b.ndim or a.shape[1:] != b.shape[1:]:
        return max(len(a), len(b))
    if n == 0:
        return extra
    same = a[:n] == b[:n]
    if same.ndim > 1:
        same = same.all(axis=1)
    return int((~same).sum()) + extra


def compare(hist: np.ndarray, item_map: np.ndarray, cand: np.ndarray,
            job_counts, ans: reference.Answer) -> dict:
    """Every number that decides ``correct``, with its limit."""
    width = max(len(hist), len(ans.hist))
    ours = np.zeros((width,), np.int64)
    ours[:len(hist)] = hist
    ref = np.zeros((width,), np.int64)
    ref[:len(ans.hist)] = ans.hist
    job = ans.levels[-1]
    worst, wrong = 0, 0
    for counts in job_counts:
        if counts.shape != job.supports.shape:
            err = int(job.supports.max(initial=1))
        else:
            err = int(np.abs(counts.astype(np.int64) - job.supports).max(
                initial=0))
        worst = max(worst, err)
        wrong += err > 0
    values = {"hist_diff": int((ours != ref).sum()),
              "item_map_diff": _rows_diff(np.asarray(item_map),
                                          ans.item_map),
              "cand_diff": _rows_diff(np.asarray(cand), job.cand),
              "support_err": worst, "jobs_wrong": wrong}
    return {name: (v, LIMITS[name]) for name, v in values.items()}


def fresh(job):
    """A job of its own over a copy of ``job``'s candidates."""
    return dataclasses.replace(job, cand=job.cand.copy())


def _launches() -> int:
    from repro_torch.kernels.support_count import launches

    return sum(launches.values())


def run(cell) -> Outcome:
    t = time.perf_counter()
    from repro_torch.core.itemsets import apriori_gen_matrix
    from repro_torch.core.runtime.job import CountJob
    from repro_torch.core.runtime.runners import make_runner

    marks = {**cell.marks, "program imports": time.perf_counter() - t}
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(cell.device)
    k = int(traffic["k"])
    n_items = int(cfg["n_items"])
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
    init_s = time.perf_counter() - t
    baskets = generator.from_config(cfg, cell.seed, dev)
    n = baskets.n_baskets
    _sync(dev)
    if dev.type == "cuda":  # the peak is the program's from here on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    lists = baskets.as_lists()
    gen_s = time.perf_counter() - t - init_s
    start_s = t - cell.t_start

    runner = make_runner(store=traffic["store"], device=cell.device)
    spans = {}
    t = time.perf_counter()
    runner.ingest(lists)
    spans["ingest"] = time.perf_counter() - t
    del lists
    t = time.perf_counter()
    hist, _ = runner.job1()
    min_count = reference.min_count(traffic["min_support"], n)
    item_map = np.flatnonzero(hist >= min_count)
    runner.place(item_map)
    spans["place"] = time.perf_counter() - t

    sizes = [len(item_map)]
    singles = np.arange(len(item_map), dtype=np.int32)[:, None]
    cand = apriori_gen_matrix(singles)
    for level in range(2, k):
        counts, _ = runner.count(CountJob(level, cand, min_count))
        frequent = cand[counts >= min_count]
        sizes += [len(cand), len(frequent)]
        cand = apriori_gen_matrix(frequent)
    sizes.append(len(cand))
    job = CountJob(k, cand, min_count)
    runner.count(job)  # warm-up: every shape of the timed job
    gc.collect()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start

    shape = {"rows": n, "cands": len(cand), "items": len(item_map), "k": k}
    readings = Readings(spans=spans, shape=shape)
    results = []
    breakdown = None
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": cell.chips}
    if not cell.trace:
        ends = []
        while True:
            counts, _ = runner.count(fresh(job))
            results.append(counts)
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= cell.seconds:
                break
        count_job_s = (ends[-1] - t0) / len(results)
        each = np.diff([t0] + ends)
    else:
        count_job_s = None
        jobs = int(traffic["trace_jobs"])
        for _ in range(jobs):
            before = _launches()
            counts, prof = runner.count(fresh(job))
            results.append(counts)
            readings.encode_seconds.append(prof.encode_seconds)
            readings.launches.append(_launches() - before)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with warnings.catch_warnings():
            # torch 2.11 warns that a profile without a schedule keeps one
            # cycle's events: this window is that one cycle.
            warnings.filterwarnings("ignore", message=".*clears events")
            with torch.profiler.profile(activities=activities) as prof:
                with torch.profiler.record_function(devtrace.WINDOW):
                    for _ in range(jobs):
                        with torch.profiler.record_function(devtrace.JOB):
                            counts, _ = runner.count(fresh(job))
                        results.append(counts)
                    _sync(dev)
        dev_events, host_events = devtrace.events(prof)
        lo, hi = devtrace.window(host_events)
        readings.traced_jobs = jobs
        readings.window = (lo, hi)
        readings.device_events = [e for e in dev_events
                                  if e[2] > lo and e[1] < hi]
        device["busy_s"] = devtrace.busy_seconds(dev_events, lo, hi)
        device["window_s"] = hi - lo
        breakdown = devtrace.breakdown(dev_events, host_events, lo, hi)
    window_jobs = len(results)
    device["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)

    runner.close()
    del runner, job
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ans = reference.answer(baskets.items, baskets.offsets, n_items,
                           traffic["min_support"], k, device=dev)
    ref_s = time.perf_counter() - t
    checks = compare(hist, item_map, cand, results, ans)

    _say(f"card: {_card(dev)}; torch {torch.__version__}")
    _say(f"{cell.name}: N {n}, mean basket "
         f"{float(np.diff(baskets.offsets).mean()):.4f}, min count "
         f"{min_count}, F1 {sizes[0]}, then C/F by level {sizes[1:]}; "
         f"store {traffic['store']}, k {k}")
    start = ", ".join(f"{name} {v:.4f}" for name, v in marks.items())
    _say(f"set-up {setup_s:.4f} s (start and imports {start_s:.4f}: {start}; "
         f"CUDA init {init_s:.4f}, baskets {gen_s:.4f}, ingest "
         f"{spans['ingest']:.4f}, job1+place {spans['place']:.4f}); "
         f"{window_jobs} jobs; reference {ref_s:.4f} s")
    if count_job_s is not None:
        q = np.quantile(each, [0, 0.5, 0.95, 1])
        thirds = [float(np.median(part))
                  for part in np.array_split(each, 3) if len(part)]
        _say(f"count_job_s {count_job_s:.6f}; a job min {q[0]:.6f} median "
             f"{q[1]:.6f} p95 {q[2]:.6f} max {q[3]:.6f} s; median of each "
             f"third of the window {thirds}")
    return Outcome(attempted=window_jobs, failed=checks["jobs_wrong"][0],
                   end_to_end={"count_job_s": count_job_s,
                               "setup_s": setup_s},
                   checks=checks, readings=readings, device=device,
                   breakdown=breakdown)
