"""The hand-written CUDA kernels of the PyTorch port, on a card.

Every test here is marked ``cuda`` and skips on a machine without a CUDA
card (deciding inside the fixture, never at import).  The module imports
neither JAX nor ``repro``, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held exactly against its plain PyTorch version on the same
device (counts are integers), on ragged shapes, C larger than a tile, mixed
k with kvec = -1 pad rows, and wide vocabularies; the bitmap kernel also on
the edges of its TMA/wgmma design (``WGMMA_EDGES``).  Small mines through
each store on the card (host loop and level ladder) are held against
brute-force counting, the trie and hash-tree stores against
``perfect_hash``, and a mine with the default kernel switch must move the
kernel's launch counter.  Out of core, a ``.dat`` mined through
``ChunkedDatasetReader`` with the kernels on must equal the resident
``perfect_hash`` mine, and the block count of a chunk shorter than
``block_n`` and of a ragged final chunk must equal the plain path's.  A
device loss on the card at k = 3 abandons the engine's queue, and a fresh
runner resumes from the level checkpoint with the clean answer; a parity
cell holds the Hadoop model (``sim/trie``) to ``packed_bitmap`` on the card.
Spawned ``torch.distributed`` worlds mine through ``ShardedRunner``: one
NCCL rank, and two gloo ranks sharing the card on 1x2 and 2x1 meshes, each
with the ``TorchRunner`` answer and the launches its shard asks for.
"""

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
    ARRAY_STORES, ITEM_PAD, pack_bitmap, padded_from_transactions)
from repro_torch.core.stores.packed_bitmap import pack_candidates_device  # noqa: E402
from repro_torch.data import ChunkedDatasetReader, get_dataset, write_dat  # noqa: E402
from repro_torch.kernels.support_count import (  # noqa: E402
    launches, packed_support_count, packed_support_count_ref, pad_copies,
    support_count, support_count_ref,
)
from repro_torch.launch.multihost import launch_cluster  # noqa: E402

pytestmark = pytest.mark.cuda


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
    return [torch.from_numpy(pack_bitmap(bitmap)).to(dev), cp.to(dev), kvec.to(dev)]


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


@pytest.mark.parametrize("store,use_kernel", [
    ("packed_bitmap", True), ("bitmap", True), ("perfect_hash", False),
    ("packed_bitmap", False), ("bitmap", False)])
def test_small_mine_on_card_matches_brute_force(cuda, store, use_kernel,
                                                monkeypatch):
    if store != "perfect_hash":
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", use_kernel)
    db = get_dataset("T10I4D100K", scale=0.002, seed=0)
    want = brute_force_frequent(db, math.ceil(0.02 * len(db)))
    got = FrequentItemsetMiner(min_support=0.02, store=store).mine(db)
    assert got.itemsets == want


def _small_db():
    db = get_dataset("T10I4D100K", scale=0.002, seed=0)
    return db, brute_force_frequent(db, math.ceil(0.02 * len(db)))


@pytest.mark.parametrize("store,kernel", [("packed_bitmap", "packed_support_count"),
                                          ("bitmap", "support_count")])
@pytest.mark.parametrize("trim", [False, True])
def test_ladder_mine_on_card_matches_brute_force(cuda, store, kernel, trim):
    """The level ladder through a kernel store at its default switch: the
    kernel launches once per row block and level (one unchunked pass)."""
    assert ARRAY_STORES[store].use_kernel is None
    db, want = _small_db()
    before = launches[kernel]
    got = FrequentItemsetMiner(min_support=0.02, store=store, device_loop=True,
                               trim=trim, block_n=64).mine(db)
    assert got.itemsets == want
    expected = sum(math.ceil(p.n_pad / 64) for p in got.levels[1:])
    assert launches[kernel] - before == expected > 0


@pytest.mark.parametrize("store,kernel", [("packed_bitmap", "packed_support_count"),
                                          ("bitmap", "support_count")])
def test_default_switch_mine_launches_kernel(cuda, store, kernel):
    db, want = _small_db()
    before = launches[kernel]
    got = FrequentItemsetMiner(min_support=0.02, store=store).mine(db)
    assert got.itemsets == want
    assert launches[kernel] > before


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
                 ("bitmap", "support_count")]


@pytest.mark.parametrize("store,kernel", KERNEL_STORES)
@pytest.mark.parametrize("chunk", [100, 333, 5000])
def test_out_of_core_mine_on_card_matches_resident(cuda, tmp_path, store,
                                                   kernel, chunk,
                                                   monkeypatch):
    """A ``.dat`` mined out of core through a kernel store at its default
    switch (chunks shorter than ``block_n``, a ragged last chunk, one chunk
    of several row blocks) equals the resident ``perfect_hash`` mine; each
    kernel launch is one row block of one chunk for one candidate chunk."""
    assert ARRAY_STORES[store].use_kernel is None
    db = get_dataset("BMS_WebView_2", scale=0.02, seed=1)  # 1,550 rows
    path = str(tmp_path / "db.dat")
    write_dat(path, db)
    reader = ChunkedDatasetReader(path, chunk_transactions=chunk)
    want = FrequentItemsetMiner(min_support=0.01).mine(db)
    waves = []
    orig = TorchRunner._count_chunked_async

    def logged(self, job):
        waves.append(len(job.cand))
        return orig(self, job)

    monkeypatch.setattr(TorchRunner, "_count_chunked_async", logged)
    before, copies = launches[kernel], pad_copies["support_count"]
    got = FrequentItemsetMiner(min_support=0.01, store=store, block_n=256,
                               cand_block=512).mine(reader)
    assert got.itemsets == want.itemsets and got.max_k >= 5
    assert all(p.chunks == reader.n_chunks for p in got.levels)
    rows = [min(chunk, len(db) - i) for i in range(0, len(db), chunk)]
    expected = (sum(math.ceil(c / 512) for c in waves)
                * sum(math.ceil(r / 256) for r in rows))
    assert launches[kernel] - before == expected > 0
    assert pad_copies["support_count"] == copies


@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap"])
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
    copies = pad_copies["support_count"]
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
    assert pad_copies["support_count"] == copies
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
for store in ("packed_bitmap", "bitmap"):
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
    blocks on 2x1."""
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
            blocks = math.ceil(5000 / 2048)
            local = math.ceil(rec["local_rows"] / 2048)
            assert rec["local_rows"] == 5000 // n_data
            want = rec["base"][kernel] // blocks * local
            assert rec["sharded"] == {
                k: (want if k == kernel else 0) for k in rec["sharded"]}


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
def test_token_set_miner_on_card(cuda, store, kernel):
    """``TokenSetMiner`` on the card through a kernel store equals the CPU
    ``perfect_hash`` mine, and its kernel launches once per row block and
    candidate chunk of every level (SPC: one wave per level)."""
    from repro_torch.analytics import TokenSetMiner
    from repro_torch.data.pipeline import SyntheticLM

    pipe = SyntheticLM(512, 8, 256, seed=0)
    want = TokenSetMiner(min_support=0.05, store="perfect_hash", window=32,
                         device="cpu").mine_steps(pipe, [0, 1])
    before = dict(launches)
    got = TokenSetMiner(min_support=0.05, store=store, window=32).mine_steps(
        pipe, [0, 1])
    assert got.itemsets == want.itemsets and got.max_k == 4
    blocks = math.ceil(got.n_transactions / 2048)
    expected = blocks * sum(math.ceil(p.n_candidates / 32_768)
                            for p in got.levels[1:])
    assert {k: launches[k] - before[k] for k in launches} == {
        k: (expected if k == kernel else 0) for k in launches}
