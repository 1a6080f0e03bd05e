"""The per-layer readers and the trace arithmetic, on hand-made inputs
(CPU)."""

from __future__ import annotations

import math

import pytest

from perfbench import devtrace, harness, roofline
from perfbench.tests.conftest import BENCH, run_cell

# count_share's (chip_smoke.py) shape: N 2^23, F 4,096, C 8,192, and its
# int8 rate: 8,192 operations a clock on each of 132 SMs at 1,980 MHz.
SHARE = dict(n=1 << 23, c=8192, f=4096)
SHARE_RATE = 8192 * 132 * 1980e6


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"test_reader_{name}")


def readings(**kw):
    base = dict(spans={}, shape={"rows": 1 << 20, "cands": 447_931,
                                 "items": 947, "k": 2})
    base.update(kw)
    return harness.Readings(**base)


def test_roofline_matches_count_share():
    n, c, f = SHARE["n"], SHARE["c"], SHARE["f"]
    w = f // 32
    # count_share: 2 N F C operations; kernel 2 reads N F + C F + 2 C 4
    # bytes, kernel 1 N W 4 + C W 4 + 2 C 4.
    assert roofline.int8_ops(n, c, f) == 2 * n * f * c
    assert roofline.bitmap_bytes(n, c, f) == n * f + c * f + 2 * c * 4
    assert roofline.packed_bytes(n, c, f) == n * w * 4 + c * w * 4 + 2 * c * 4
    rates = dict(ops_per_s=SHARE_RATE, bytes_per_s=3.35e12)
    # PERF.md's kernel table: the share's bound is 262.9 ms for both.
    for bound in (roofline.packed_count_bound_s(n, c, f, **rates),
                  roofline.bitmap_count_bound_s(n, c, f, **rates)):
        assert round(bound * 1e3, 1) == 262.9
    # Against the data sheet's 1,979 TOP/s.
    assert roofline.packed_count_bound_s(n, c, f) == pytest.approx(
        2 * n * c * f / 1.979e15)


def test_the_roofline_counts_the_items_the_inputs_need():
    # 949 frequent items take 30 packed words (960 bits); a program that
    # pads them to 1,024 columns is credited with none of the padding.
    n, c = 1 << 20, 449_826
    assert roofline.int8_ops(n, c, 949) == 2 * n * c * 949
    assert roofline.packed_bytes(n, c, 949) == (n + c) * 30 * 4 + 2 * c * 4
    assert roofline.packed_bytes(n, c, 960) == roofline.packed_bytes(
        n, c, 949)
    assert roofline.packed_bytes(n, c, 961) > roofline.packed_bytes(
        n, c, 960)
    assert roofline.bitmap_bytes(n, c, 949) == (n + c) * 949 + 2 * c * 4


def test_kernel_rooflines_read_their_own_kernel():
    bound = roofline.packed_count_bound_s(1 << 20, 447_931, 947)
    events = [("void packed_support_count_kernel<1>(CUtensorMap)", 0.0,
               bound * 2),
              ("void support_count_kernel<2>(CUtensorMap)", 0.0, 5.0),
              ("Memcpy DtoH (Device -> Pinned)", 0.0, 9.0)]
    r = readings(traced_jobs=1, device_events=events, window=(0.0, 9.0))
    assert reader("k1_roofline_pct").read(r) == pytest.approx(50.0)
    k2 = roofline.bitmap_count_bound_s(1 << 20, 447_931, 947)
    assert reader("k2_roofline_pct").read(r) == pytest.approx(
        100 * k2 / 5.0)
    empty = readings(traced_jobs=1, device_events=events[2:])
    assert reader("k1_roofline_pct").read(empty) is None
    assert reader("k2_roofline_pct").read(empty) is None


def test_busy_and_idle_from_a_hand_made_trace():
    # Two jobs in [10, 20]: busy 10-12, 11-13 (overlap), 15-16, 19-21
    # (clipped to 20): 3 + 1 + 1 = 5 s of 10.
    events = [("k", 10, 12), ("copy", 11, 13), ("k", 15, 16),
              ("k", 19, 21), ("before", 2, 9)]
    r = readings(traced_jobs=2, device_events=events, window=(10.0, 20.0))
    assert reader("device_busy_s").read(r) == pytest.approx(2.5)
    assert reader("idle_pct").read(r) == pytest.approx(50.0)
    assert devtrace.gaps(events, 10, 20) == [(13, 15), (16, 19)]
    assert reader("idle_pct").read(readings()) is None
    assert reader("device_busy_s").read(readings()) is None


def test_breakdown_names_what_the_host_did_in_each_gap():
    device = [("kernel", 0, 4), ("kernel", 6, 7), ("copy", 9, 10)]
    host = [(devtrace.WINDOW, 0, 10), ("aten::index_select", 3.5, 6.5),
            ("cudaStreamSynchronize", 7.5, 8.5)]
    out = devtrace.breakdown(device, host, 0, 10)
    assert out["device_ops"] == [["kernel", 5], ["copy", 1]]
    # gap 4-6 midpoint 5: inside index_select; gap 7-9 midpoint 8: the sync
    assert out["idle_gaps"] == [["aten::index_select", 2],
                                ["cudaStreamSynchronize", 2]]
    assert devtrace.window(host) == (0, 10)


def test_dispatch_is_the_mean_of_job_profiles():
    from repro_torch.core.runtime.job import JobProfile

    jobs = [JobProfile(k=2, encode_seconds=s, seconds=2 * s)
            for s in (0.25, 0.5, 0.75)]
    r = readings(encode_seconds=[p.encode_seconds for p in jobs])
    assert reader("dispatch_s").read(r) == pytest.approx(0.5)
    assert reader("dispatch_s").read(readings()) is None


def test_spans_read_set_up():
    r = readings(spans={"ingest": 4.5, "place": 2.25})
    assert reader("ingest_s").read(r) == 4.5
    assert reader("place_s").read(r) == 2.25


def _count_launches(monkeypatch):
    """Make the CPU path count a launch where the card would launch."""
    import repro_torch.kernels.support_count as sc
    from repro_torch.core.stores import ARRAY_STORES

    for store in ("packed_bitmap", "bitmap"):
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", True)
    for name in ("packed_support_count", "support_count"):
        plain = getattr(sc, name)

        def counted(*args, _plain=plain, _name=name):
            sc.launches[_name] += 1
            return _plain(*args)
        monkeypatch.setattr(sc, name, counted)


@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap"])
def test_launches_per_job_repeat_exactly(tiny_root, monkeypatch, store):
    _count_launches(monkeypatch)
    captured = []
    monkeypatch.setattr(harness, "read_metrics",
                        _capture(harness.read_metrics, captured))
    rc, line = run_cell(tiny_root, f"tiny-c3-{store}", trace=1)
    assert rc == 0 and line["correct"], line
    r = captured[0]
    # the engine: one launch a 2,048-row block (and one for a ragged tail
    # block) and candidate chunk of 32,768 rows
    blocks = r.shape["rows"] // 2048 + (r.shape["rows"] % 2048 > 0)
    chunks = math.ceil(r.shape["cands"] / 32_768)
    assert r.launches == [blocks * chunks] * len(r.encode_seconds)
    assert line["metrics"]["launches_per_job"]["value"] == blocks * chunks


def test_no_launches_no_reading(tiny_root):
    rc, line = run_cell(tiny_root, "tiny-c2-perfect_hash", trace=1)
    assert rc == 0 and line["correct"]
    assert "launches_per_job" not in line["metrics"]
    assert set(line["metrics"]) >= {"ingest_s", "place_s", "dispatch_s"}


def _capture(fn, into):
    def wrapped(entries, cell, readers_dir, readings):
        into.append(readings)
        return fn(entries, cell, readers_dir, readings)
    return wrapped
