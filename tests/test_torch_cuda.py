"""The hand-written CUDA kernels of the PyTorch port, on a card.

Every test here is marked ``cuda`` and skips on a machine without a CUDA
card (deciding inside the fixture, never at import).  The module imports
neither JAX nor ``repro``, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held exactly against its plain PyTorch version on the same
device (counts are integers), on ragged shapes, C larger than a tile, mixed
k with kvec = -1 pad rows, and wide vocabularies; the bitmap kernel also on
the edges of its TMA/wgmma design (``WGMMA_EDGES``), and the
gather-AND-popcount kernel of ``perfect_hash`` on row counts around its
32-row words, trimmed widths, k up to 9, pad rows and N over several of its
row tiles (``GATHER_CASES``), composed and as its two halves (words packed
once, then counted twice).  A ``perfect_hash`` DB placed on the card is
packed once at ``place``: its counts launch no pack, and its plain path
counts row blocks of the bitmap alone.
Small mines through each store on the card (host loop and level ladder, the
kernel stores with the kernel on and off) are held against brute-force
counting, the trie and hash-tree stores against ``perfect_hash``, and a
mine with the default kernel switch must move its kernel's launch counter
by row blocks x candidate chunks and no other (``perfect_hash``, whose
kernel counts all rows in one call, by candidate chunks: ``row_calls``,
shared with ``chip_smoke.py``; its pack counter by one a build of its
tensors).  Out of core, a ``.dat`` mined through
``ChunkedDatasetReader`` with the kernels on must equal the resident
``perfect_hash`` mine on its plain path, and the block count of a chunk
shorter than ``block_n`` and of a ragged final chunk must equal the plain
path's.  A device loss on the card at k = 3 abandons the engine's queue, and a fresh
runner resumes from the level checkpoint with the clean answer; a parity
cell holds the Hadoop model (``sim/trie``) to ``packed_bitmap`` on the card.
Spawned ``torch.distributed`` worlds mine through ``ShardedRunner``: one
NCCL rank, and two gloo ranks sharing the card on 1x2 and 2x1 meshes, each
with the ``TorchRunner`` answer and the launches its shard asks for.
"""

import functools
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.itemsets import brute_force_frequent  # noqa: E402
from repro_torch.core.itemsets import level_to_matrix  # noqa: E402
from repro_torch.core.miner import FrequentItemsetMiner  # noqa: E402
from repro_torch.core.runtime.engine import MapReduceEngine  # noqa: E402
from repro_torch.core.runtime.runners import TorchRunner  # noqa: E402
from repro_torch.core.stores import (  # noqa: E402
    ARRAY_STORES, ITEM_PAD, PerfectHashStore, pack_bitmap,
    padded_from_transactions)
from repro_torch.core.stores.packed_bitmap import pack_candidates_device  # noqa: E402
from repro_torch.data import ChunkedDatasetReader, get_dataset, write_dat  # noqa: E402
from repro_torch.kernels.support_count import (  # noqa: E402
    gather_and_count, gather_and_count_bits, gather_and_count_pack,
    gather_and_count_ref, gather_and_count_words, launches, packed_support_count,
    packed_support_count_ref, pad_copies, support_count, support_count_ref,
)
from repro_torch.launch.multihost import launch_cluster  # noqa: E402

pytestmark = pytest.mark.cuda


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def row_calls(store, n, block_n=2048):
    """Kernel launches of one candidate chunk over n rows: ``chip_smoke``'s
    count, which asks the store whether it counts every row in one call."""
    return _chip_smoke().row_calls(store, n, block_n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _packed_args(dev, n, w, c, ks, pads, seed):
    rng = np.random.default_rng(seed)
    f = w * 32
    bitmap = np.zeros((n, f), np.uint8)
    bitmap[:, : f - 1] = rng.random((n, f - 1)) < 0.35
    bitmap[::5, 31] = 1  # set the int32 sign bit of word 0
    rows = [np.sort(rng.choice(f - 1, ks[i % len(ks)], replace=False))
            for i in range(c)]
    cp = torch.cat([pack_candidates_device(
        torch.from_numpy(r.astype(np.int32)[None, :]), w) for r in rows])
    kvec = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    if pads:
        kvec[-pads:] = -1
    return [pack_bitmap(torch.from_numpy(bitmap).to(dev)), cp.to(dev), kvec.to(dev)]


def _bitmap_args(dev, n, f, c, ks, pads, seed, dtype=torch.int8):
    rng = np.random.default_rng(seed)
    bitmap = (rng.random((n, f)) < 0.3).astype(np.uint8)
    khot = np.zeros((c, f), np.int8)
    kvec = np.zeros(c, np.int32)
    for i in range(c):
        kvec[i] = ks[i % len(ks)]
        khot[i, rng.choice(f, kvec[i], replace=False)] = 1
    if pads:
        kvec[-pads:] = -1
    return [torch.from_numpy(bitmap).to(dev).to(dtype),
            torch.from_numpy(khot).to(dev), torch.from_numpy(kvec).to(dev)]


@pytest.mark.parametrize("n,w,c,ks,pads", [
    (8, 4, 4, [1], 0), (100, 5, 70, [2], 0), (256, 8, 128, [3], 0),
    (513, 9, 300, [5], 0), (64, 16, 1024, [4], 0),      # C > tile
    (90, 6, 50, [1, 2, 3, 4], 6),                       # mixed k + pads
    (256, 160, 300, [1, 2, 3, 6], 11),                  # W >= 128
    (2048, 16, 4096, [2], 5),                           # main-path block
])
def test_packed_kernel_matches_plain(cuda, n, w, c, ks, pads):
    args = _packed_args(cuda, n, w, c, ks, pads, seed=n + c)
    before = launches["packed_support_count"]
    got = packed_support_count(*args)
    torch.cuda.synchronize()
    assert launches["packed_support_count"] == before + 1
    want = packed_support_count_ref(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if pads:
        assert (got[-pads:] == 0).all()


@pytest.mark.parametrize("n,f,c,ks,pads", [
    (8, 16, 4, [1], 0), (100, 130, 70, [2], 0), (256, 128, 128, [3], 0),
    (513, 257, 300, [5], 0), (64, 512, 1024, [4], 0),   # C > tile
    (1200, 96, 33, [7], 0), (128, 64, 30, [2, 3, 4], 5),  # mixed k + pads
    (300, 4096, 200, [1, 2, 3, 6], 9),                  # wide vocabulary
    (2048, 512, 4096, [2], 5),                          # main-path block
])
def test_support_count_kernel_matches_plain(cuda, n, f, c, ks, pads):
    args = _bitmap_args(cuda, n, f, c, ks, pads, seed=n * 7 + c)
    before = launches["support_count"]
    got = support_count(*args)
    torch.cuda.synchronize()
    assert launches["support_count"] == before + 1
    torch.testing.assert_close(got, support_count_ref(*args), rtol=0, atol=0)


def test_support_count_kernel_takes_uint8_bitmap(cuda):
    args = _bitmap_args(cuda, 200, 140, 180, [4], 3, seed=11, dtype=torch.uint8)
    torch.testing.assert_close(support_count(*args), support_count_ref(*args),
                               rtol=0, atol=0)


# The wgmma kernel's edges: 256-candidate tiles (two 128-candidate halves),
# 64-row stages, 128-byte k-slabs resident up to F = 640 and streamed
# beyond, N split across blocks when the candidate tiles do not fill the
# SMs, and the pad copy when F % 16 != 0.
WGMMA_EDGES = {
    "c_not_tile_multiple": dict(n=300, f=128, c=300),
    "n_split": dict(n=2048, f=512, c=1000),
    "n_below_64": dict(n=40, f=256, c=500),
    "n_one": dict(n=1, f=64, c=300, zero_k=5),
    "n_not_stage_multiple": dict(n=1000, f=384, c=600, zero_k=7),
    "f128_single_slab": dict(n=2048, f=128, c=7503),
    "f4096_streamed": dict(n=300, f=4096, c=600, ks=[1, 2, 3, 6], pads=9),
    "f_not_16_pad_route": dict(n=513, f=257, c=300, ks=[5]),
    "khot_up_to_127": dict(n=512, f=256, c=400, big=True),
    "mixed_k_pads": dict(n=700, f=512, c=900, ks=[2, 3, 4, 5], pads=17),
    "uint8_bitmap": dict(n=600, f=512, c=520, dtype=torch.uint8),
    "row_view_at_offset": dict(n=3000, f=512, c=700, view=(2048, 3000)),
}


def _edge_args(dev, n, f, c, ks=(2,), pads=0, big=False, zero_k=0,
               dtype=torch.int8, view=None, seed=0):
    rng = np.random.default_rng(seed)
    bitmap = (rng.random((n, f)) < 0.3).astype(np.uint8)
    khot = np.zeros((c, f), np.int8)
    kvec = np.zeros(c, np.int32)
    for i in range(c):
        cols = rng.choice(f, ks[i % len(ks)], replace=False)
        if big:  # entries up to 127; kvec = some row's dot, so it matches
            khot[i, cols] = rng.integers(1, 128, len(cols))
            row = bitmap[rng.integers(n)].astype(np.int64)
            kvec[i] = int(row @ khot[i].astype(np.int64))
        else:
            khot[i, cols] = 1
            kvec[i] = len(cols)
    kvec[:zero_k] = 0  # counts rows with a zero dot: zero-filled rows must not
    if pads:
        kvec[-pads:] = -1
    bm = torch.from_numpy(bitmap).to(dev).to(dtype)
    if view is not None:
        bm = bm[view[0]:view[1]]
    return [bm, torch.from_numpy(khot).to(dev), torch.from_numpy(kvec).to(dev)]


@pytest.mark.parametrize("case", list(WGMMA_EDGES))
def test_support_count_wgmma_edges(cuda, case):
    spec = WGMMA_EDGES[case]
    args = _edge_args(cuda, seed=len(case), **spec)
    before, pads_before = launches["support_count"], pad_copies["support_count"]
    got = support_count(*args)
    torch.cuda.synchronize()
    assert launches["support_count"] == before + 1
    assert pad_copies["support_count"] == pads_before + (spec["f"] % 16 != 0)
    want = support_count_ref(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want.sum()) > 0  # the case exercises matches, not only zeros
    if spec.get("pads"):
        assert (got[-spec["pads"]:] == 0).all()


# The packed kernel's edges: int8 wgmma over bits unpacked in shared
# memory, 256-candidate tiles, 64-row tiles, candidates resident up to
# W = 20 words and streamed beyond (two 64-row tiles a slab), N split
# across blocks when the candidate tiles do not fill the SMs, and the pad
# copy when W % 4 != 0.  Words are dense random bits, not k-hot rows, so a
# wrong bit map cannot hide behind sparse candidates, and each kvec is some
# row's true count.
PACKED_EDGES = {
    "w4_n1": dict(n=1, w=4, c=300),
    "w5_n63_pad_route": dict(n=63, w=5, c=300),
    "w20_n64_resident": dict(n=64, w=20, c=700),
    "w21_n65_streamed_pad_route": dict(n=65, w=21, c=700),
    "w128_ragged_streamed": dict(n=1000, w=128, c=520, pads=9),
    "w128_n1": dict(n=1, w=128, c=300),
    "c_below_tile": dict(n=700, w=16, c=100),
    "split_n_resident": dict(n=4096, w=16, c=1000, pads=5),
    "split_n_streamed": dict(n=2000, w=24, c=300),
    "many_tiles_ragged": dict(n=777, w=8, c=9000),
    "view_w5_odd_offset": dict(n=3000, w=5, c=400, view=(1001, 2999)),
    "view_w16_odd_offset": dict(n=3000, w=16, c=500, view=(777, 2100)),
}


def _dense_packed_args(dev, n, w, c, pads=0, view=None, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    cwords = rng.integers(0, 2 ** 32, (c, w), dtype=np.uint32)
    words[::3, 0] |= np.uint32(1 << 31)   # the int32 sign bit on both sides
    cwords[::2, -1] |= np.uint32(1 << 31)
    lo, hi = view if view is not None else (0, n)
    pick = words[rng.integers(lo, hi, size=c)] & cwords
    kvec = np.unpackbits(pick.view(np.uint8), axis=1).sum(1).astype(np.int32)
    if pads:
        kvec[-pads:] = -1
    t = torch.from_numpy(words.view(np.int32)).to(dev)
    return [t[lo:hi], torch.from_numpy(cwords.view(np.int32)).to(dev),
            torch.from_numpy(kvec).to(dev)]


@pytest.mark.parametrize("case", list(PACKED_EDGES))
def test_packed_kernel_edges(cuda, case):
    spec = PACKED_EDGES[case]
    args = _dense_packed_args(cuda, seed=len(case), **spec)
    before = launches["packed_support_count"]
    copies = pad_copies["packed_support_count"]
    got = packed_support_count(*args)
    torch.cuda.synchronize()
    assert launches["packed_support_count"] == before + 1
    assert pad_copies["packed_support_count"] == copies + (spec["w"] % 4 != 0)
    want = packed_support_count_ref(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    pads = spec.get("pads", 0)
    assert int(want[:spec["c"] - pads].min()) >= 1  # kvec is a true count
    if pads:
        assert (got[-pads:] == 0).all()


def test_packed_kernel_hit_counters_flush(cuda):
    """The packed kernel counts a candidate's matches in 16-bit halves of a
    register and flushes them every 16,384 row tiles.  Here 132 candidate
    tiles keep N unsplit, so one block sees all 2^21 + 77 rows (32,769
    tiles), and all-zero candidates with kvec 0 match every row: a counter
    that was never flushed would wrap."""
    n, w, c = 2 ** 21 + 77, 4, 132 * 256
    rng = np.random.default_rng(21)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, w),
                                          dtype=np.int64).astype(np.int32))
    cwords = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (c, w),
                                           dtype=np.int64).astype(np.int32))
    kvec = torch.full((c,), 32, dtype=torch.int32)
    cwords[::2] = 0
    kvec[::2] = 0
    args = [words.to(cuda), cwords.to(cuda), kvec.to(cuda)]
    got = packed_support_count(*args)
    want = sum(packed_support_count_ref(args[0][i:i + 8192], *args[1:])
               for i in range(0, n, 8192))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[::2] == n).all() and int(got[1::2].sum()) > 0


def test_kernel_on_row_block_views(cuda):
    """The engine hands the kernels row slices of the placed DB (views at
    an offset); a ragged tail block included."""
    packed, cp, kv = _packed_args(cuda, 1000, 16, 200, [2], 0, seed=3)
    bitmap, khot, kv2 = _bitmap_args(cuda, 1000, 512, 200, [2], 0, seed=3)
    for lo, hi in ((0, 512), (512, 1000), (999, 1000)):
        torch.testing.assert_close(
            packed_support_count(packed[lo:hi], cp, kv),
            packed_support_count_ref(packed[lo:hi], cp, kv), rtol=0, atol=0)
        torch.testing.assert_close(
            support_count(bitmap[lo:hi], khot, kv2),
            support_count_ref(bitmap[lo:hi], khot, kv2), rtol=0, atol=0)


# The gather-AND-popcount kernel: (Nb, F_pad, C, k, pad rows, row view).
# Nb around a 32-row word and the count groups' widths; F_pad 128, 1,024,
# 3,456 and trimmed widths that are no multiple of 128 (949, odd, so rows
# start at every byte offset); k 1-6 unrolled and 9 looped; C 1, 129 and
# 70,000; a row block viewed at an offset, as the engine hands it over.
# Then whole chunks over several row tiles (a tile is about 16 MB of column
# words: 131,072 rows at F 1,024, 141,312 at F 949, 1,048,576 at F 128), N
# not a multiple of 32 and a ragged last tile: k 1-8 unrolled and 9 looped,
# F_pad 128 and 1,024 and a trimmed F, a view at an offset.
GATHER_CASES = {
    "n1_k1": (1, 128, 129, 1, 0, None),
    "n31_pads": (31, 1024, 129, 2, 5, None),
    "n32_c1": (32, 128, 1, 3, 0, None),
    "n33_wide": (33, 3456, 129, 4, 9, None),
    "n2047_c70000": (2047, 1024, 70_000, 2, 17, None),
    "n2048_c70000_k3": (2048, 1024, 70_000, 3, 0, None),
    "n5000_trimmed": (5000, 949, 129, 5, 3, None),
    "n2048_trimmed_k6": (2048, 949, 4096, 6, 0, None),
    "k9_looped": (300, 256, 500, 9, 5, None),
    "view_at_offset": (3048, 1024, 4096, 2, 0, (1000, 3048)),
    "wide_c1": (700, 3456, 1, 1, 0, None),
    "tiles3_k1": (300_001, 1024, 1000, 1, 3, None),
    "tiles3_k2": (300_001, 1024, 4096, 2, 7, None),
    "tiles3_k3_trimmed": (300_007, 949, 2000, 3, 0, None),
    "tiles3_k4": (262_145, 1024, 1000, 4, 0, None),
    "tiles2_k5_f128": (1_100_003, 128, 129, 5, 5, None),
    "tiles3_k6_trimmed": (283_000, 949, 1000, 6, 0, None),
    "tiles3_k7": (300_001, 1024, 500, 7, 2, None),
    "tiles3_k8_f128": (2_100_001, 128, 129, 8, 0, None),
    "tiles3_k9_looped": (300_001, 1024, 500, 9, 0, None),
    "tiles3_view_at_offset": (301_000, 1024, 1000, 2, 0, (1000, 300_999)),
}


def _gather_args(dev, n, f, c, k, pads, view, seed):
    """{0,1} rows (half set) with the always-zero pad column f - 1, random
    ids below it (row 0 holds candidate 0's items), pad rows last."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bitmap = (torch.rand((n, f), generator=gen, device=dev) < 0.5).to(
        torch.uint8)
    bitmap[:, f - 1] = 0
    cand = torch.randint(0, f - 1, (c, k), generator=gen, device=dev,
                         dtype=torch.int32)
    lo = view[0] if view else 0
    bitmap[lo, cand[0].long()] = 1
    if pads:
        cand[-pads:] = f - 1
    return (bitmap[view[0]:view[1]] if view else bitmap), cand


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_and_count_kernel_matches_plain(cuda, case):
    n, f, c, k, pads, view = GATHER_CASES[case]
    bitmap, cand = _gather_args(cuda, n, f, c, k, pads, view, seed=len(case))
    before = dict(launches)
    got = gather_and_count(bitmap, cand)
    torch.cuda.synchronize()
    assert {name: launches[name] - before[name] for name in launches} == {
        name: int(name in ("gather_and_count", "gather_and_count_pack"))
        for name in launches}
    want = gather_and_count_ref(bitmap, cand)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want[0]) >= 1  # the case exercises matches, not only zeros
    if pads:
        assert (got[-pads:] == 0).all()


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_and_count_bits_match_plain(cuda, case):
    """Words packed once (``gather_and_count_pack``) serve two counts
    (``gather_and_count_bits``), each one count launch and no pack, both
    equal to the plain gathers; up to 5,000 rows the words also unpack to
    the bitmap, with zero bits past its last row."""
    n, f, c, k, pads, view = GATHER_CASES[case]
    bitmap, cand = _gather_args(cuda, n, f, c, k, pads, view, seed=len(case))
    rows = bitmap.shape[0]
    bits = gather_and_count_pack(bitmap)
    assert bits.dtype == torch.int32
    assert bits.shape == (f, gather_and_count_words(rows))
    before = dict(launches)
    got = gather_and_count_bits(bits, rows, cand)
    again = gather_and_count_bits(bits, rows, cand)
    torch.cuda.synchronize()
    assert {name: launches[name] - before[name] for name in launches} == {
        name: 2 * int(name == "gather_and_count") for name in launches}
    want = gather_and_count_ref(bitmap, cand)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(again, want, rtol=0, atol=0)
    assert int(want[0]) >= 1
    if rows <= 5000:
        shifts = torch.arange(32, dtype=torch.int32, device=cuda)
        unpacked = ((bits[:, :, None] >> shifts) & 1).reshape(f, -1)
        assert torch.equal(unpacked[:, :rows].T.to(torch.uint8),
                           (bitmap != 0).to(torch.uint8))
        assert not unpacked[:, rows:].any()


def _placed_perfect_hash(block_n=48, cand_block=1000):
    """A ``perfect_hash`` runner with the small DB placed on the card, and
    every pair of its items."""
    db, _ = _small_db()
    runner = TorchRunner(store="perfect_hash", block_n=block_n,
                         cand_block=cand_block)
    runner.ingest(db)
    hist, _ = runner.job1()
    before = dict(launches)
    runner.place(np.nonzero(hist >= 4)[0])
    torch.cuda.synchronize()
    placed = {name: launches[name] - before[name] for name in launches}
    n_items = runner.engine._enc.n_items
    pairs = np.array([(a, b) for a in range(n_items)
                      for b in range(a + 1, n_items)], dtype=np.int32)
    return runner, pairs, placed


def test_placed_rows_are_packed_once(cuda):
    """``place`` packs the rows once; a count over them launches one count
    a candidate chunk and no pack, and equals the plain gathers over the
    placed bitmap."""
    assert PerfectHashStore.use_kernel is None
    runner, pairs, placed = _placed_perfect_hash()
    assert placed == {name: int(name == "gather_and_count_pack")
                      for name in launches}
    assert pairs.shape[0] > 2 * 1000  # several candidate chunks
    before = dict(launches)
    got = runner.engine.count_candidates(pairs)
    assert {name: launches[name] - before[name] for name in launches} == {
        name: math.ceil(pairs.shape[0] / 1000) * int(name == "gather_and_count")
        for name in launches}
    bitmap = runner.engine._trans_device["bitmap"]
    want = gather_and_count_ref(bitmap, torch.from_numpy(pairs).to(cuda))
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert want.sum() > 0


def test_plain_path_on_card_counts_row_blocks(cuda, monkeypatch):
    """With ``use_kernel=False`` on the card the engine counts the placed
    rows in ``block_n``-row blocks of the bitmap alone (the packed words
    are no row tensor), launches nothing, and equals the plain gathers over
    all the rows."""
    runner, pairs, _ = _placed_perfect_hash()
    bitmap = runner.engine._trans_device["bitmap"]
    monkeypatch.setattr(PerfectHashStore, "use_kernel", False)
    calls, orig = [], PerfectHashStore.count_block

    def logged(trans, cands):
        calls.append((sorted(trans), trans["bitmap"].shape[0]))
        return orig(trans, cands)

    monkeypatch.setattr(PerfectHashStore, "count_block", staticmethod(logged))
    before = dict(launches)
    got = runner.engine.count_candidates(pairs)
    assert dict(launches) == before
    n = bitmap.shape[0]
    assert n % 48  # a ragged tail block
    per_chunk = [48] * (n // 48) + [n % 48]
    assert calls == [(["bitmap"], r) for r in per_chunk] * math.ceil(
        pairs.shape[0] / 1000)
    want = gather_and_count_ref(bitmap, torch.from_numpy(pairs).to(cuda))
    np.testing.assert_array_equal(got, want.cpu().numpy())


def test_wrappers_reject_bad_inputs(cuda):
    words = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    kv = torch.zeros((8,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        packed_support_count(words.float(), words, kv)
    with pytest.raises(ValueError, match="contiguous"):
        packed_support_count(words, torch.zeros((4, 8), dtype=torch.int32,
                                                device=cuda).T, kv)
    with pytest.raises(TypeError):
        support_count(words.float(), words.to(torch.int8), kv)
    with pytest.raises(ValueError, match="different devices"):
        packed_support_count(words, words.cpu(), kv)
    rows = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        gather_and_count(rows, words.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather_and_count(rows, words.T)
    with pytest.raises(ValueError, match="at least one item"):
        gather_and_count(rows, words[:, :0])


@pytest.mark.parametrize("store,use_kernel", [
    ("packed_bitmap", True), ("bitmap", True), ("perfect_hash", True),
    ("perfect_hash", False), ("packed_bitmap", False), ("bitmap", False)])
def test_small_mine_on_card_matches_brute_force(cuda, store, use_kernel,
                                                monkeypatch):
    monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", use_kernel)
    db = get_dataset("T10I4D100K", scale=0.002, seed=0)
    want = brute_force_frequent(db, math.ceil(0.02 * len(db)))
    got = FrequentItemsetMiner(min_support=0.02, store=store).mine(db)
    assert got.itemsets == want


def _log_builds(monkeypatch):
    """The row counts of every build of the ``perfect_hash`` store's
    tensors from here on, each of which packs its rows once on the card."""
    builds, orig = [], PerfectHashStore.device_transaction_inputs

    def logged(padded, bitmap):
        builds.append(bitmap.shape[0])
        return orig(padded, bitmap)

    monkeypatch.setattr(PerfectHashStore, "device_transaction_inputs",
                        staticmethod(logged))
    return builds


def _small_db():
    db = get_dataset("T10I4D100K", scale=0.002, seed=0)
    return db, brute_force_frequent(db, math.ceil(0.02 * len(db)))


@pytest.mark.parametrize("store,kernel", [("packed_bitmap", "packed_support_count"),
                                          ("bitmap", "support_count"),
                                          ("perfect_hash", "gather_and_count")])
@pytest.mark.parametrize("trim", [False, True])
def test_ladder_mine_on_card_matches_brute_force(cuda, store, kernel, trim,
                                                monkeypatch):
    """The level ladder through a kernel store at its default switch: the
    kernel launches once per row block and level (one unchunked pass;
    ``perfect_hash`` once a level), and ``perfect_hash`` packs its rows
    once a build of its tensors (the placed rows, the ladder's own and one
    a trim), never a level."""
    assert ARRAY_STORES[store].use_kernel is None
    db, want = _small_db()
    builds = _log_builds(monkeypatch)
    before = dict(launches)
    got = FrequentItemsetMiner(min_support=0.02, store=store, device_loop=True,
                               trim=trim, block_n=64).mine(db)
    assert got.itemsets == want
    expected = sum(row_calls(store, p.n_pad, 64) for p in got.levels[1:])
    assert launches[kernel] - before[kernel] == expected > 0
    packs = launches["gather_and_count_pack"] - before["gather_and_count_pack"]
    assert packs == (len(builds) if store == "perfect_hash" else 0)
    assert store != "perfect_hash" or len(builds) >= 2  # placed, ladder's


@pytest.mark.parametrize("store,kernel", [("packed_bitmap", "packed_support_count"),
                                          ("bitmap", "support_count"),
                                          ("perfect_hash", "gather_and_count")])
def test_default_switch_mine_launches_kernel(cuda, store, kernel, monkeypatch):
    """A host-loop mine at the default switch launches its store's kernel
    once per row block and candidate chunk of every wave (``perfect_hash``
    once a chunk), and no other."""
    assert ARRAY_STORES[store].use_kernel is None
    db, want = _small_db()
    waves = []
    orig = MapReduceEngine.count_candidates_async

    def logged(self, cand):
        waves.append(len(cand))
        return orig(self, cand)

    monkeypatch.setattr(MapReduceEngine, "count_candidates_async", logged)
    builds = _log_builds(monkeypatch)
    before = dict(launches)
    got = FrequentItemsetMiner(min_support=0.02, store=store).mine(db)
    assert got.itemsets == want
    expected = row_calls(store, len(db)) * sum(math.ceil(c / 32_768)
                                               for c in waves)
    packs = len(builds) if store == "perfect_hash" else 0
    assert {k: launches[k] - before[k] for k in launches} == {
        k: (expected if k == kernel else packs if k == "gather_and_count_pack"
            else 0) for k in launches}
    assert expected > 0
    assert len(builds) == (store == "perfect_hash")  # the one placement


@pytest.mark.parametrize("store", ["sorted_prefix", "hash_bucket"])
def test_trie_and_hash_tree_stores_match_perfect_hash(cuda, store):
    """k = 1..4 over a DB placed on the card, with ragged row blocks and
    candidate chunks; then a small host-loop mine against brute force."""
    db, want = _small_db()
    counts = {}
    for name in (store, "perfect_hash"):
        runner = TorchRunner(store=name, block_n=48, cand_block=1000)
        runner.ingest(db)
        hist, _ = runner.job1()
        runner.place(np.nonzero(hist >= 4)[0])
        n_items = runner.engine._enc.n_items
        rng = np.random.default_rng(0)
        counts[name] = [runner.engine.count_candidates(level_to_matrix(sorted(
            {tuple(sorted(rng.choice(n_items, k, replace=False).tolist()))
             for _ in range(3000)}))) for k in range(1, 5)]
    for k, (got, ref) in enumerate(zip(counts[store], counts["perfect_hash"]), 1):
        np.testing.assert_array_equal(got, ref, err_msg=f"{store} k={k}")
        assert ref.sum() > 0 or k == 4  # k <= 3 exercises matches
    assert FrequentItemsetMiner(min_support=0.02, store=store).mine(db).itemsets == want



KERNEL_STORES = [("packed_bitmap", "packed_support_count"),
                 ("bitmap", "support_count"),
                 ("perfect_hash", "gather_and_count")]


@pytest.mark.parametrize("store,kernel", KERNEL_STORES)
@pytest.mark.parametrize("chunk", [100, 333, 5000])
def test_out_of_core_mine_on_card_matches_resident(cuda, tmp_path, store,
                                                   kernel, chunk,
                                                   monkeypatch):
    """A ``.dat`` mined out of core through a kernel store at its default
    switch (chunks shorter than ``block_n``, a ragged last chunk, one chunk
    of several row blocks) equals the resident ``perfect_hash`` mine on its
    plain path; each kernel launch is one row block (``perfect_hash``: all
    rows) of one chunk for one candidate chunk."""
    assert ARRAY_STORES[store].use_kernel is None
    db = get_dataset("BMS_WebView_2", scale=0.02, seed=1)  # 1,550 rows
    path = str(tmp_path / "db.dat")
    write_dat(path, db)
    reader = ChunkedDatasetReader(path, chunk_transactions=chunk)
    monkeypatch.setattr(ARRAY_STORES["perfect_hash"], "use_kernel", False)
    want = FrequentItemsetMiner(min_support=0.01).mine(db)
    monkeypatch.setattr(ARRAY_STORES["perfect_hash"], "use_kernel", None)
    waves = []
    orig = TorchRunner._count_chunked_async

    def logged(self, job):
        waves.append(len(job.cand))
        return orig(self, job)

    monkeypatch.setattr(TorchRunner, "_count_chunked_async", logged)
    before, copies = launches[kernel], dict(pad_copies)
    got = FrequentItemsetMiner(min_support=0.01, store=store, block_n=256,
                               cand_block=512).mine(reader)
    assert got.itemsets == want.itemsets and got.max_k >= 5
    assert all(p.chunks == reader.n_chunks for p in got.levels)
    rows = [min(chunk, len(db) - i) for i in range(0, len(db), chunk)]
    expected = (sum(math.ceil(c / 512) for c in waves)
                * sum(row_calls(store, r, 256) for r in rows))
    assert launches[kernel] - before == expected > 0
    assert pad_copies == copies


@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap", "perfect_hash"])
def test_count_block_short_and_ragged_chunks_match_plain(cuda, store,
                                                         monkeypatch):
    """``count_block`` through the kernel over a chunk shorter than
    ``block_n`` and over a ragged final chunk equals the plain path's on
    the card, and every FIFO entry it leaves carries a CUDA event (an entry
    without one would make ``drain_ready`` block)."""
    padded, _ = padded_from_transactions(
        get_dataset("T10I4D100K", scale=0.01, seed=2))
    item_map = np.nonzero(np.bincount(padded[padded < ITEM_PAD]) >= 20)[0]
    engine = MapReduceEngine(store=store, block_n=512, cand_block=700,
                             inflight=8)
    runner = TorchRunner(store=store)
    rng = np.random.default_rng(3)
    cands = [np.unique(np.sort(np.stack(
        [rng.choice(len(item_map), k, replace=False) for _ in range(2000)]),
        axis=1), axis=0).astype(np.int32) for k in (1, 2, 3)]
    for lo, hi in ((0, 300), (300, 1000)):  # 300 < block_n; 700 = 512 + 188
        enc = runner.encode_block(padded[lo:hi], item_map)
        for cand in cands:
            monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", None)
            pending = engine.count_block_async(enc, cand)
            assert engine._queue
            assert all(entry[4] is not None for entry in engine._queue)
            got = pending.result()
            monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", False)
            np.testing.assert_array_equal(got, engine.count_block(enc, cand))
            assert got.sum() > 0


@pytest.mark.parametrize("store,kernel", KERNEL_STORES)
@pytest.mark.parametrize("device_loop", [False, True])
def test_service_on_card_matches_cpu(cuda, store, kernel, device_loop):
    """A small ``MiningService`` on the card through a kernel store (at its
    default switch), with one-row evictions and host-wave or ladder
    refreshes, equals the same program on the CPU plain path step by step;
    every FIFO entry a delta leaves carries a CUDA event, and a one-row
    eviction launches the kernel once per candidate chunk of every tracked
    level."""
    from repro_torch.serve import MiningService

    kw = dict(min_support=0.04, store=store, n_slots=4, slot_size=250,
              eviction="basket", staleness=0.5, max_k=6,
              device_loop=device_loop, trim=True, compact_churn=0.0)
    card, cpu = MiningService(**kw), MiningService(device="cpu", **kw)
    assert card.runner.engine.device.type == "cuda"
    copies = dict(pad_copies)
    db = get_dataset("T10I4D100K", scale=0.02, seed=3)  # 2,000 baskets
    refreshed = 0
    for i in range(7):
        batch = db[i * 250:(i + 1) * 250]
        card.ingest(batch)
        cpu.ingest(batch)
        assert all(entry[4] is not None for entry in card.runner.engine._queue)
        for n in (1, 1, 9):
            chunks = sum(math.ceil(len(tl.cand) / card.runner.engine.cand_block)
                         for tl in card._levels.values() if tl.cand.size)
            real = bool((card._slots[0].padded[:n] < ITEM_PAD).any())
            before = launches[kernel]
            card.evict(n)
            if n == 1 and real:
                assert launches[kernel] - before == chunks
            cpu.evict(n)
        want, got = cpu.query(), card.query()
        assert card.window() == cpu.window()
        assert got.itemsets == want.itemsets
        assert (got.refreshed, got.stale_reason) == (want.refreshed,
                                                     want.stale_reason)
        refreshed += got.refreshed
        st_card, st_cpu = card.stats(), cpu.stats()
        assert st_card == st_cpu
    assert refreshed >= 2 and card.delta_jobs > 0
    assert got.itemsets == brute_force_frequent(card.window(), got.min_count,
                                                max_k=6)
    # Stale serving and the background refresh, parked on CUDA events.
    card.ingest(db[1750:2000])
    res = card.query(staleness=4.0)
    assert not res.refreshed
    card.refresh_async()
    for _ in range(200):
        if not card.refresh_async():
            break
    assert not card.stats()["refresh_in_flight"]
    res = card.query()
    assert res.itemsets == brute_force_frequent(card.window(), res.min_count,
                                                max_k=6)
    assert pad_copies == copies
    card.close()
    cpu.close()


def test_device_loss_on_card_then_resume(cuda, tmp_path):
    """``device_loss`` at the k = 3 dispatch of a ``packed_bitmap`` mine on
    the card raises after abandoning the engine's FIFO; a miner on a fresh
    runner and the same checkpoint directory resumes at k = 3 without Job1,
    its FIFO holds no entry of the abandoned runner, and the answer equals
    a clean mine."""
    from repro_torch.core.runtime import DeviceLostError, FaultPlan
    from repro_torch.core.runtime import faults as F

    db = get_dataset("BMS_WebView_2", scale=0.05, seed=0)  # ten levels
    clean = FrequentItemsetMiner(min_support=0.003,
                                 store="packed_bitmap").mine(db)
    assert clean.max_k >= 4
    lost = TorchRunner(store="packed_bitmap",
                       fault_plan=FaultPlan(F.device_loss(k=3)))
    abandoned = []
    abandon = lost.engine.abandon
    lost.engine.abandon = lambda: (abandoned.extend(
        entry[0] for entry in lost.engine._queue), abandon())
    with pytest.raises(DeviceLostError):
        FrequentItemsetMiner(min_support=0.003, runner=lost,
                             checkpoint_dir=str(tmp_path)).mine(db)
    assert not lost.engine._queue
    assert all(handle._cancelled for handle in abandoned)
    fresh = TorchRunner(store="packed_bitmap")
    ks = []

    def count_async(job, orig=fresh.count_async):
        ks.append(job.k)
        queued = {id(entry[0]) for entry in fresh.engine._queue}
        assert not queued & {id(h) for h in abandoned}
        return orig(job)

    fresh.job1 = lambda: pytest.fail("Job1 ran on resume")
    fresh.count_async = count_async
    before = launches["packed_support_count"]
    res = FrequentItemsetMiner(min_support=0.003, runner=fresh,
                               checkpoint_dir=str(tmp_path)).mine(db)
    assert res.itemsets == clean.itemsets
    assert ks and min(ks) == 3
    assert launches["packed_support_count"] > before


def test_parity_cell_sim_trie_vs_card(cuda):
    from repro_torch.core.runtime import SimRunner, run_parity_cell

    db = get_dataset("T10I4D100K", scale=0.005, seed=0)
    before = launches["packed_support_count"]
    cell = run_parity_cell(db, 0.02, {
        "sim/trie": lambda: SimRunner(structure="trie", executor="process"),
        "torch/packed_bitmap": lambda: TorchRunner(store="packed_bitmap")})
    assert cell.n_itemsets > 0
    assert launches["packed_support_count"] > before
    assert cell.backends["sim/trie"]["n_frequent"] == \
        cell.backends["torch/packed_bitmap"]["n_frequent"]


# -- the sharded runner over torch.distributed, on the card ---------------------

_SHARDED_CHILD = r"""
import json, math, sys
import torch
from repro_torch.distributed import ctx

backend, n_data, n_cand, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
ctx.initialize_multihost(device="cuda", backend=backend, timeout=300)
from repro_torch.core.miner import FrequentItemsetMiner
from repro_torch.core.runtime import ShardedRunner, TorchRunner
from repro_torch.data import get_dataset
from repro_torch.kernels.support_count import launches, reset_launches
from repro_torch.launch.mesh import make_data_cand_mesh, make_data_mesh

db = get_dataset("T10I4D100K", scale=0.05, seed=0)  # 5,000 rows: 3 blocks
mesh = (make_data_cand_mesh(n_data, n_cand) if n_cand
        else make_data_mesh(n_data))
rec = {}
for store in ("packed_bitmap", "bitmap", "perfect_hash"):
    reset_launches()
    base = FrequentItemsetMiner(min_support=0.02, runner=TorchRunner(
        store=store)).mine(db)
    base_launches = dict(launches)
    reset_launches()
    runner = ShardedRunner(store=store, mesh=mesh,
                           cand_axes=("cand",) if n_cand else ())
    res = FrequentItemsetMiner(min_support=0.02, runner=runner).mine(db)
    rec[store] = {"same": res.itemsets == base.itemsets,
                  "n": len(res.itemsets), "base": base_launches,
                  "sharded": dict(launches),
                  "local_rows": runner.engine._local_enc.n_transactions,
                  "collectives": runner.engine.collectives}
with open(f"{out}.{ctx.process_index()}", "w") as f:
    json.dump(rec, f)
from repro_torch.launch.multihost import exit_rank
exit_rank()
"""


@pytest.mark.parametrize("backend,n_data,n_cand", [
    ("nccl", 1, 1), ("gloo", 1, 2), ("gloo", 2, 0)])
def test_sharded_mine_on_card_matches_torch_runner(cuda, tmp_path, backend,
                                                   n_data, n_cand):
    """A spawned one-rank NCCL world (1x1 data x cand) and two gloo ranks
    sharing this card (1x2 and 2x1) mine through ``ShardedRunner`` with the
    ``TorchRunner`` answer; each rank launches its kernel once per row block
    of its shard per candidate chunk: the single device's count on 1x1 and
    1x2 (half of each chunk a launch), ceil(2,500 / 2,048) = 2 of its 3 row
    blocks on 2x1 (``perfect_hash``: one call over its rows, as on one
    device)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = str(tmp_path / "rank")
    world = n_data * max(1, n_cand)
    launch_cluster([sys.executable, "-c", _SHARDED_CHILD, backend,
                    str(n_data), str(n_cand), out], world, base_env=env,
                   timeout=600)
    for r in range(world):
        recs = json.load(open(f"{out}.{r}"))
        for store, kernel in KERNEL_STORES:
            rec = recs[store]
            assert rec["same"] and rec["n"] > 0
            assert rec["collectives"] > 0
            blocks = row_calls(store, 5000)
            local = row_calls(store, rec["local_rows"])
            assert rec["local_rows"] == 5000 // n_data
            want = rec["base"][kernel] // blocks * local
            # one placement each: perfect_hash packs its rows once
            packs = int(store == "perfect_hash")
            assert rec["base"]["gather_and_count_pack"] == packs
            assert rec["sharded"] == {
                k: (want if k == kernel else packs
                    if k == "gather_and_count_pack" else 0)
                for k in rec["sharded"]}


# -- the LM and the token-set miner --------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b"])
def test_serve_engine_on_card_matches_cpu(cuda, arch):
    """A reduced-width ``ServeEngine`` on the card: float32 greedy tokens
    equal the CPU engine's (TF32 off), prefill + decode equal the full
    forward within 1e-3, and bfloat16 logits are finite and deterministic."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize, tree_map
    from repro_torch.serve import ServeEngine

    cfg = get_reduced(arch)
    params = materialize(torch.Generator().manual_seed(0),
                         TM.abstract_params(cfg), dtype_override=torch.float32)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ServeEngine(cfg, params, max_len=32, device="cpu").generate(
            prompts, 16)
        eng = ServeEngine(cfg, params, max_len=32, device=cuda)
        assert eng.params["embed"]["table"].is_cuda
        np.testing.assert_array_equal(eng.generate(prompts, 16), want)
        p = tree_map(lambda x: x.to(cuda), params)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 33)).astype(np.int32)).to(cuda)
        cache = materialize(None, TM.abstract_cache(cfg, 2, 64),
                            dtype_override=torch.float32, device=cuda)
        _, cache = TM.prefill(p, {"tokens": toks[:, :32]}, cfg, cache)
        ld, _ = TM.decode_step(p, toks[:, 32:], cache, 33, cfg)
        x, _ = TM.forward(p, {"tokens": toks}, cfg)
        ref = TM._logits(p, TL.rmsnorm(p["final_norm"], x[:, -1:]), cfg)[:, 0]
        assert float((ld - ref).abs().max() / ref.abs().max()) < 1e-3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    bf16 = materialize(torch.Generator(device=cuda).manual_seed(0),
                       TM.abstract_params(cfg))
    eng = ServeEngine(cfg, bf16, max_len=32, device=cuda)
    runs = [eng.generate(prompts, 8) for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    cache = materialize(None, TM.abstract_cache(cfg, 2, 32), device=cuda)
    logits, _ = TM.prefill(eng.params, {"tokens": torch.from_numpy(
        prompts).to(cuda)}, cfg, cache)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("store,kernel", KERNEL_STORES)
def test_token_set_miner_on_card(cuda, store, kernel, monkeypatch):
    """``TokenSetMiner`` on the card through a kernel store equals the CPU
    ``perfect_hash`` mine, and its kernel launches once per row block and
    candidate chunk of every level (SPC: one wave per level; ``perfect_hash``
    once a chunk, and one pack a build of its tensors)."""
    from repro_torch.analytics import TokenSetMiner
    from repro_torch.data.pipeline import SyntheticLM

    pipe = SyntheticLM(512, 8, 256, seed=0)
    want = TokenSetMiner(min_support=0.05, store="perfect_hash", window=32,
                         device="cpu").mine_steps(pipe, [0, 1])
    builds = _log_builds(monkeypatch)
    before = dict(launches)
    got = TokenSetMiner(min_support=0.05, store=store, window=32).mine_steps(
        pipe, [0, 1])
    assert got.itemsets == want.itemsets and got.max_k == 4
    blocks = row_calls(store, got.n_transactions)
    expected = blocks * sum(math.ceil(p.n_candidates / 32_768)
                            for p in got.levels[1:])
    packs = len(builds) if store == "perfect_hash" else 0
    assert {k: launches[k] - before[k] for k in launches} == {
        k: (expected if k == kernel else packs if k == "gather_and_count_pack"
            else 0) for k in launches}
    assert len(builds) == (store == "perfect_hash")  # the one placement


# -- LM training ---------------------------------------------------------------

def _train_setup(cfg, dev, seed=0):
    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize, tree_map

    params = materialize(torch.Generator().manual_seed(seed),
                         TM.abstract_params(cfg), dtype_override=torch.float32)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 64)).astype(np.int32))}
    return (TM.trainable(tree_map(lambda t: t.to(dev), params)),
            {k: v.to(dev) for k, v in batch.items()})


def _rel_norm(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b"])
@pytest.mark.parametrize("compress", [False, True])
def test_train_step_on_card_matches_cpu(cuda, arch, compress):
    """A reduced float32 train step (two microbatches) on the card: loss
    within 1e-4 and every gradient leaf within 1e-3 (relative norm) of the
    CPU's, TF32 off.  The compressed step's updated parameters, ``m``,
    ``v`` and ``ef`` are held to the CPU's step fed the card's gradients:
    int8 rounding boundaries make the compressed update a step function of
    the gradient's last bits."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize, tree_leaves, tree_map
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import opt_abstract_with_ef

    cfg = get_reduced(arch)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            p, batch = _train_setup(cfg, dev)
            loss, _, grads = TT._microbatch_grads(p, batch, cfg, 2)
            out[str(dev)] = (float(loss), [g.cpu() for g in
                                           tree_leaves(grads)], grads)
        (l_cpu, g_cpu, _), (l_card, g_card, grads_card) = (
            out["cpu"], out[str(cuda)])
        assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
        for a, b in zip(g_card, g_cpu):
            if float(b.abs().max()) > 0:
                assert _rel_norm(a, b) < 1e-3

        ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        opt_spec = opt_abstract_with_ef(TM.abstract_params(cfg), ocfg,
                                        compress)
        states = {}
        for dev in ("cpu", cuda):
            p, batch = _train_setup(cfg, dev)
            opt = materialize(None, opt_spec, device=dev)
            fed = tree_map(lambda g: g.to(dev), grads_card)
            real = TT._microbatch_grads
            TT._microbatch_grads = lambda *a: (torch.zeros(()), {}, fed)
            try:
                step = TT.make_train_step(cfg, ocfg, 2, compress)
                p, opt, _ = step(p, opt, batch, 0)
            finally:
                TT._microbatch_grads = real
            states[str(dev)] = [t.detach().cpu() for t in
                                tree_leaves({"p": p, "o": opt})]
        p0 = [t.detach() for t in tree_leaves(
            {"p": _train_setup(cfg, "cpu")[0],
             "o": materialize(None, opt_spec, device="cpu")})]
        for a, b, z in zip(states[str(cuda)], states["cpu"], p0):
            scale = (b.float() - z.float()).norm()
            if float(scale) > 0:
                assert float((a.float() - b.float()).norm() / scale) < 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b"])
def test_remat_modes_on_card_give_equal_gradients(cuda, arch):
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_leaves

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        grads = {}
        for mode in ("none", "full", "dots"):
            cfg = dataclasses.replace(get_reduced(arch), remat=mode)
            p, batch = _train_setup(cfg, cuda)
            loss, _ = TM.loss_fn(p, batch, cfg)
            grads[mode] = torch.autograd.grad(loss, tree_leaves(p),
                                              allow_unused=True)
        for mode in ("full", "dots"):
            for a, b in zip(grads[mode], grads["none"]):
                assert (a is None) == (b is None)
                if b is not None and float(b.abs().max()) > 0:
                    assert _rel_norm(a, b) < 1e-6
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_trainer_on_card_resumes(cuda, tmp_path):
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_reduced("qwen2-1.5b")
    pipe = SyntheticLM(cfg.vocab_size, 2, 32, seed=1)
    ocfg = OptConfig(lr=1e-3, total_steps=8, warmup_steps=2)
    kw = dict(ckpt_every=2, ckpt_dir=str(tmp_path))
    t1 = Trainer(cfg, ocfg, TrainerConfig(total_steps=4, **kw), pipe.iterator)
    assert tree_leaves(t1.params)[0].is_cuda
    r1 = t1.run()
    t2 = Trainer(cfg, ocfg, TrainerConfig(total_steps=8, **kw), pipe.iterator)
    r2 = t2.run()
    assert r1["final_step"] == 4 and r2["final_step"] == 8
    assert all(p.is_cuda and p.requires_grad for p in tree_leaves(t2.params))
    assert r2["final_loss"] < r1["log"][0]["loss"]


def _to(tree, dev):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.parametrize("arch,layer", [
    ("recurrentgemma-2b", 0),      # rglru
    ("mamba2-2.7b", 0),            # ssd
    ("deepseek-v3-671b", 0),       # mla
    ("llama-3.2-vision-11b", 3),   # cross, attn_gate 0.5
])
def test_mixer_layer_on_card_matches_cpu(cuda, arch, layer):
    """One reduced layer in float32 (TF32 off): ``layer_apply``,
    ``layer_prefill`` (output and every cache leaf) and one
    ``layer_decode`` step on the card, each within 1e-4 (relative max
    error) of the CPU's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import blocks as TB
    from repro_torch.models.params import materialize

    cfg = get_reduced(arch)
    temporal, channel = TB.layer_kinds(cfg)[layer]
    lp = materialize(torch.Generator().manual_seed(layer),
                     TB.layer_abstract(cfg, temporal, channel),
                     dtype_override=torch.float32)
    if temporal == "cross":
        lp["attn_gate"].fill_(0.5)  # zero-init: the layer would add nothing
    rng = np.random.default_rng(layer)
    b, s = 2, 45  # 45: no multiple of mamba2's chunk
    x = torch.from_numpy(rng.standard_normal((b, s + 1, cfg.d_model),
                                             dtype=np.float32))
    vis = torch.from_numpy(rng.standard_normal(
        (b, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32))
    pos = torch.arange(s + 1).expand(b, s + 1)

    def run(dev):
        p, xx, pp = _to(lp, dev), x.to(dev), pos.to(dev)
        kw = {"vis_embeds": vis.to(dev)} if temporal == "cross" else {}
        y, _ = TB.layer_apply(p, xx, temporal, channel, cfg, positions=pp, **kw)
        cache = materialize(None, TB.cache_abstract(cfg, temporal, b, 64),
                            dtype_override=torch.float32, device=dev)
        yp, cache = TB.layer_prefill(p, xx[:, :s], temporal, channel, cfg,
                                     positions=pp[:, :s], cache=cache, **kw)
        yd, cache = TB.layer_decode(p, xx[:, s:], temporal, channel, cfg,
                                    cache=cache, cache_len=s + 1,
                                    positions=pp[:, s:])
        return [t.cpu() for t in [y, yp, yd] + [cache[k] for k in sorted(cache)]]

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, got = run("cpu"), run(cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a - w).abs().max() / w.abs().max()) < 1e-4


def test_moe_layer_on_card_matches_cpu(cuda):
    """The reduced deepseek-v3 MoE layer in float32 (TF32 off): router
    probabilities within 1e-5 of the CPU's; the routed experts and the
    shared one within 1e-4 on the card's routing fed to both sides (a
    near-tie may choose other experts on the two devices: the share of
    tokens routed otherwise is printed); the whole layer and its aux loss
    within 1e-4 where no token is routed otherwise."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe as TMoE
    from repro_torch.models.params import materialize

    cfg = get_reduced("deepseek-v3-671b")
    p = materialize(torch.Generator().manual_seed(5),
                    TMoE.moe_abstract(cfg), dtype_override=torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 40, cfg.d_model), dtype=np.float32))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sides = {}
        for dev in ("cpu", cuda):
            pp, xg = _to(p, dev), TMoE.group(x.to(dev), cfg)
            probs = TMoE.router_probs(pp, xg)
            d, c = TMoE.route(probs, cfg.moe.top_k,
                              TMoE._capacity(xg.shape[1], cfg), torch.float32)
            sides[str(dev)] = (pp, xg, probs, d, c)
        pc, xc, probs_c, d_cpu, _ = sides["cpu"]
        pg, xg, probs_g, d_card, c_card = sides[str(cuda)]
        assert float((probs_g.cpu() - probs_c).abs().max()
                     / probs_c.abs().max()) < 1e-5
        flipped = (d_card.cpu() != d_cpu).flatten(2).any(-1)  # (G, S)
        print(f"moe card vs cpu: {float(flipped.float().mean()):.4f} of "
              "tokens routed otherwise")
        fed = TMoE.experts(pc, xc, d_card.cpu(), c_card.cpu(), cfg)
        got = TMoE.experts(pg, xg, d_card, c_card, cfg).cpu()
        assert float((got - fed).abs().max() / fed.abs().max()) < 1e-4
        if not bool(flipped.any()):
            (yc, ac), (yg, ag) = (TMoE.moe_layer(pc, x, cfg),
                                  TMoE.moe_layer(pg, x.to(cuda), cfg))
            assert float((yg.cpu() - yc).abs().max() / yc.abs().max()) < 1e-4
            assert abs(float(ag) - float(ac)) <= 1e-4 * abs(float(ac))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


_ONE_RANK = """
import dataclasses, json
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), n_layers=3)
print(json.dumps(D.one_rank_check(cfg, 2, 128, device="cuda", steps=1)))
"""


def test_dry_run_on_one_rank_of_the_card(cuda):
    """``chip_smoke.py`` phase 13 (c) at a small shape, in a subprocess (it
    makes a one-rank NCCL group): on a (1, 1) mesh of the card the dry
    run's flops equal ``FlopCounterMode`` over the real step, and its
    argument bytes the bytes of the tensors placed on the card, exactly."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _ONE_RANK], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cuda"
    assert rec["predicted_flops"] == rec["flops"] > 0
    assert rec["predicted_argument_bytes"] == rec["placed_bytes"] > 0
    assert rec["peak_bytes"] >= rec["placed_bytes"]
