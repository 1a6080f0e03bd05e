"""The program's spans on a card: they lie on the profiler's clock as host
annotations, their device-side copies count as no device time, and a
traced cell reports the six set-up spans (``cuda``: each test skips
without a card)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import devtrace
from perfbench.tests.conftest import run_cell
from perfbench.tests.test_perfbench_spans import SPANS

pytestmark = pytest.mark.cuda

JOB = ("repro_torch.engine.encode", "repro_torch.engine.launch",
       "repro_torch.engine.wait")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap",
                                   "perfect_hash"])
def test_job_spans_are_host_intervals_only(card, store):
    from repro_torch.core.itemsets import apriori_gen_matrix
    from repro_torch.core.runtime.job import CountJob
    from repro_torch.core.runtime.runners import TorchRunner

    rng = np.random.default_rng(5)
    baskets = [rng.integers(0, 120, int(rng.integers(1, 16))).tolist()
               for _ in range(5000)]
    runner = TorchRunner(store=store, cand_block=2048, device="cuda")
    runner.ingest(baskets)
    hist, _ = runner.job1()
    runner.place(np.flatnonzero(hist > 0))
    cand = apriori_gen_matrix(
        np.arange(int((hist > 0).sum()), dtype=np.int32)[:, None])
    want, _ = runner.count(CountJob(2, cand))  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            got, _ = runner.count(CountJob(2, cand))
            torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    device, host = devtrace.events(prof)
    assert device, "the trace holds no device interval"
    assert not [n for n, _, _ in device if n.startswith("repro_torch.")]
    lo, hi = devtrace.window(host)
    chunks = -(-len(cand) // 2048)
    for name in JOB:
        inside = [(s, e) for n, s, e in host if n == name]
        assert len(inside) == chunks, (name, len(inside))
        assert all(lo <= s <= e <= hi for s, e in inside)
    runner.close()


def test_a_traced_cell_reports_the_set_up_spans(card, tiny_root):
    rc, line = run_cell(tiny_root, "tiny-c3-packed_bitmap", device="cuda",
                        trace=1)
    assert rc == 0 and line["correct"], line
    assert all(line["metrics"][name]["value"] > 0 for name in SPANS)
    ops = [name for name, _ in line["breakdown"]["device_ops"]]
    assert not [n for n in ops if n.startswith("repro_torch.")], ops
