"""PyTorch port vs JAX package: out-of-core mining and the data layer.

The same NumPy-seeded inputs go through ``repro`` and ``repro_torch``, and
every result must be equal with no tolerance: ``ChunkedDatasetReader``'s
chunk matrices and its ``.chunkmeta.json`` sidecar, ``load_dense``'s
``.dense.npz`` sidecar (each package reads the other's), the ``.dat`` IO,
the adversarial generators and ``basket_stream``, the engine's block count
(``count_block``) on every store, and the chunked mine, which must also
equal the port's in-memory mine.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.miner import FrequentItemsetMiner as JMiner  # noqa: E402
from repro.core.runtime.engine import MapReduceEngine as JEngine  # noqa: E402
from repro.core.runtime.runners import JaxRunner as JRunner  # noqa: E402
from repro.core.stores import encode_db as j_encode_db  # noqa: E402
from repro.data import chunked as J_chunked  # noqa: E402
from repro.data import datasets as J  # noqa: E402
from repro.data import stream as J_stream  # noqa: E402
from repro.data import transactions as J_tx  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401

from repro_torch.core.miner import FrequentItemsetMiner as TMiner  # noqa: E402
from repro_torch.core.runtime.engine import MapReduceEngine as TEngine  # noqa: E402
from repro_torch.core.runtime.runners import TorchRunner as TRunner  # noqa: E402
from repro_torch.core.stores import (  # noqa: E402
    ARRAY_STORES, encoded_db_from_numpy, padded_from_transactions)
from repro_torch.data import (  # noqa: E402
    ChunkedDatasetReader, basket_stream, dense_to_transactions, get_dataset,
    load_dense, read_dat, write_dat)
from repro_torch.data import datasets as T  # noqa: E402
from repro_torch.data import transactions as T_tx  # noqa: E402

MIN_SUPPORT = 0.03
MAX_K = 4
KERNEL_STORES = ["packed_bitmap", "bitmap"]
# Every store at its default switch, and the kernel stores forced through
# their kernels' wrappers (on CPU tensors: the kernels' plain versions).
MINE_CONFIGS = [(s, None) for s in ARRAY_STORES] + \
    [(s, True) for s in KERNEL_STORES]


def _chunk_db(seed=11, n=120, n_items=30):
    """A small DB with an empty basket (the reader must preserve N)."""
    db = get_dataset(f"T6I3D{n}", seed=seed, scale=1.0)
    db = [sorted({i % n_items for i in t}) for t in db]
    db[len(db) // 2] = []
    return db


def _write_db(tmp_path, db, gz=False, name="db"):
    path = str(tmp_path / (f"{name}.dat.gz" if gz else f"{name}.dat"))
    write_dat(path, db)
    return path


def _readers(path, **kw):
    return (ChunkedDatasetReader(path, **kw),
            J_chunked.ChunkedDatasetReader(path, **kw))


# -- the chunked reader -------------------------------------------------------

@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, None, "past_end"])
def test_chunk_matrices_match_reference(tmp_path, gz, chunk):
    """Chunk for chunk, bit for bit equal to the reference's, and their
    concatenation is the whole-file padded matrix: at chunk size 1, a
    prime, exactly N and past N."""
    db = _chunk_db()
    path = _write_db(tmp_path, db, gz)
    size = {None: len(db), "past_end": len(db) + 100}.get(chunk, chunk)
    t, j = _readers(path, chunk_transactions=size, cache=False)
    assert (len(t), t.width, t.n_raw_items, t.n_chunks,
            t.chunk_transactions) == (len(j), j.width, j.n_raw_items,
                                      j.n_chunks, j.chunk_transactions)
    assert t.n_chunks == -(-len(db) // size)
    parts, want = list(t.chunks()), list(j.chunks())
    assert len(parts) == len(want) == t.n_chunks
    for got, ref in zip(parts, want):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    whole, n_raw = padded_from_transactions(read_dat(path))
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    assert t.n_raw_items == n_raw
    assert t.describe() == j.describe()


def test_chunkmeta_sidecar_hit_invalidation_and_no_cache(tmp_path):
    db = _chunk_db()
    path = _write_db(tmp_path, db)
    r1 = ChunkedDatasetReader(path, chunk_transactions=16)
    assert not r1.scanned_from_cache
    assert os.path.exists(path + ".chunkmeta.json")
    r2 = ChunkedDatasetReader(path, chunk_transactions=16)
    assert r2.scanned_from_cache
    assert (len(r2), r2.width, r2.n_raw_items) == (len(r1), r1.width,
                                                   r1.n_raw_items)
    # Rewriting the source invalidates the sidecar (size/mtime key).
    write_dat(path, [[1, 2], [3]])
    os.utime(path, ns=(1, 1))
    r3 = ChunkedDatasetReader(path)
    assert not r3.scanned_from_cache
    assert len(r3) == 2 and r3.n_raw_items == 4
    path2 = _write_db(tmp_path, db, gz=True)
    ChunkedDatasetReader(path2, cache=False)
    assert not os.path.exists(path2 + ".chunkmeta.json")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_chunkmeta_sidecar_read_across_packages(tmp_path, writer):
    """A scan sidecar written by one package is a cache hit for the other."""
    path = _write_db(tmp_path, _chunk_db())
    first, second = ((ChunkedDatasetReader, J_chunked.ChunkedDatasetReader)
                     if writer == "torch" else
                     (J_chunked.ChunkedDatasetReader, ChunkedDatasetReader))
    a = first(path, chunk_transactions=9)
    b = second(path, chunk_transactions=9)
    assert not a.scanned_from_cache and b.scanned_from_cache
    assert (len(a), a.width, a.n_raw_items) == (len(b), b.width, b.n_raw_items)
    for x, y in zip(a.chunks(), b.chunks()):
        np.testing.assert_array_equal(x, y)


def test_memory_budget_bounds_chunks_and_bad_arguments(tmp_path):
    db = _chunk_db()
    path = _write_db(tmp_path, db)
    probe = ChunkedDatasetReader(path)
    budget = (len(db) * probe.width * 4) // 4  # >= 4 chunks
    t, j = _readers(path, memory_budget_bytes=budget)
    assert t.chunk_transactions == j.chunk_transactions \
        == budget // (t.width * 4)
    assert t.n_chunks == j.n_chunks >= 4
    assert all(p.nbytes <= budget for p in t.chunks())
    # A budget under one row still reads one row per chunk.
    assert ChunkedDatasetReader(path, memory_budget_bytes=1).chunk_transactions == 1
    with pytest.raises(ValueError, match="not both"):
        ChunkedDatasetReader(path, chunk_transactions=8,
                             memory_budget_bytes=1024)
    with pytest.raises(ValueError, match=">= 1"):
        ChunkedDatasetReader(path, chunk_transactions=0)


def test_empty_file(tmp_path):
    path = str(tmp_path / "empty.dat")
    write_dat(path, [])
    t, j = _readers(path)
    assert len(t) == len(j) == 0 and t.n_chunks == j.n_chunks == 0
    assert list(t.chunks()) == []
    assert t.width == j.width == 8


# -- .dat IO and the dense sidecar -------------------------------------------

@pytest.mark.parametrize("gz", [False, True])
def test_dat_round_trip_with_empty_baskets(tmp_path, gz):
    """Each package reads what the other writes, empty baskets kept."""
    db = [[3, 1, 1], [], [7], [], [2, 5]]
    suffix = ".dat.gz" if gz else ".dat"
    p_t = write_dat(str(tmp_path / f"t{suffix}"), db)
    p_j = J.write_dat(str(tmp_path / f"j{suffix}"), db)
    want = [[1, 3], [], [7], [], [2, 5]]
    assert read_dat(p_t) == J.read_dat(p_t) == read_dat(p_j) == want
    dense = load_dense(p_t, cache=False)
    np.testing.assert_array_equal(dense, J.load_dense(p_j, cache=False))
    assert dense_to_transactions(dense) == J.dense_to_transactions(dense) == want


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_dense_sidecar_across_packages(tmp_path, writer):
    """Hit, invalidation on rewrite, ``pad`` in the key, ``cache=False``,
    and a sidecar written by one package read by the other without a new
    parse (the sidecar file is left untouched)."""
    db = _chunk_db()
    path = _write_db(tmp_path, db)
    side = path + ".dense.npz"
    first, second = ((load_dense, J.load_dense) if writer == "torch"
                     else (J.load_dense, load_dense))
    a = first(path)
    st = os.stat(side)
    b = second(path)
    np.testing.assert_array_equal(a, b)
    assert (os.stat(side).st_ino, os.stat(side).st_mtime_ns) == \
        (st.st_ino, st.st_mtime_ns)
    with np.load(side) as z:
        assert sorted(z.files) == ["dense", "key", "pad"]
    # Another pad misses and rewrites; so does a rewritten source.
    c = second(path, pad=99)
    assert (c == 99).any() and not (c == -1).any()
    write_dat(path, [[4], [1, 2]])
    os.utime(path, ns=(1, 1))
    np.testing.assert_array_equal(second(path), [[4, -1], [1, 2]])
    np.testing.assert_array_equal(first(path), [[4, -1], [1, 2]])
    path2 = _write_db(tmp_path, db, name="nocache")
    load_dense(path2, cache=False)
    assert not os.path.exists(path2 + ".dense.npz")


# -- generators ------------------------------------------------------------------

def test_adversarial_generators_same_baskets():
    assert T.long_tail_db(400, n_items=60, seed=3) == \
        J.long_tail_db(400, n_items=60, seed=3)
    assert T.near_duplicate_db(400, n_items=50, seed=4) == \
        J.near_duplicate_db(400, n_items=50, seed=4)
    assert T.wide_sparse_db(400, n_items=2_000, seed=5) == \
        J.wide_sparse_db(400, n_items=2_000, seed=5)
    assert [(s.name, s.kind, s.description) for s in T.list_datasets()] == \
        [(s.name, s.kind, s.description) for s in J.list_datasets()]
    with pytest.raises(ValueError, match="already registered"):
        T.register_dataset(T.DATASETS["long_tail"])


def test_paper_datasets_and_host_encodings():
    t, j = T_tx.paper_datasets(scale=0.002, seed=1), \
        J_tx.paper_datasets(scale=0.002, seed=1)
    assert t == j
    db = t["BMS_WebView_2"]
    np.testing.assert_array_equal(T_tx.encode_padded(db, pad=-7),
                                  J_tx.encode_padded(db, pad=-7))
    for got, want in zip(T_tx.encode_bitmap(db, [5, 1, 9, 40], 32),
                         J_tx.encode_bitmap(db, [5, 1, 9, 40], 32)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_size", [7, 64])
def test_basket_stream_same_arrivals(batch_size):
    kw = dict(dataset="BMS_WebView_2", batch_size=batch_size, scale=0.002,
              seed=5, repeat=True, max_batches=40)
    got = list(basket_stream(**kw))
    want = list(J_stream.basket_stream(**kw))
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert (g.transactions, g.t_arrival, g.seq) == \
            (w.transactions, w.t_arrival, w.seq)
        np.testing.assert_array_equal(g.t_arrivals, w.t_arrivals)


def test_basket_stream_order_independent_of_batch_size():
    kw = dict(dataset="T10I4D100K", scale=0.002, seed=2)
    flat = [[b for a in basket_stream(batch_size=bs, **kw)
             for b in a.transactions] for bs in (5, 33)]
    assert flat[0] == flat[1]
    with pytest.raises(ValueError):
        next(basket_stream(batch_size=0, **kw))


# -- the engine's block count ----------------------------------------------------

def _block_case(seed, n, n_items=40, k_max=4):
    rng = np.random.default_rng(seed)
    db = [sorted(set(rng.integers(0, n_items, int(rng.integers(0, 10))).tolist()))
          for _ in range(n)]
    cands = {k: np.unique(np.sort(np.stack(
        [rng.choice(n_items, k, replace=False) for _ in range(300)]), axis=1),
        axis=0).astype(np.int32) for k in range(1, k_max + 1)}
    return j_encode_db(db, n_items=n_items), cands


@pytest.mark.parametrize("store,use_kernel", MINE_CONFIGS)
def test_count_block_matches_reference(store, use_kernel, monkeypatch):
    """``engine.count_block`` over ad-hoc blocks (a ragged row-block tail,
    a block shorter than ``block_n``, an empty block) at k = 1..4, and an
    empty ``cand``, equal to the reference's."""
    if use_kernel:
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", True)
    j_eng = JEngine(store=store, block_n=64, cand_block=128)
    t_eng = TEngine(store=store, block_n=64, cand_block=128, device="cpu")
    for seed, n in ((0, 200), (1, 37), (2, 0)):
        j_enc, cands = _block_case(seed, n)
        t_enc = encoded_db_from_numpy(j_enc.padded, j_enc.bitmap,
                                      j_enc.n_items)
        for k, cand in cands.items():
            got = t_eng.count_block(t_enc, cand)
            want = j_eng.count_block(j_enc, cand)
            assert got.dtype == np.int64 and got.shape == (cand.shape[0],)
            np.testing.assert_array_equal(got, want)
            if n == 0:
                assert not got.any()
        empty = np.zeros((0, 2), np.int32)
        assert t_eng.count_block(t_enc, empty).shape == \
            j_eng.count_block(j_enc, empty).shape == (0,)
    assert not t_eng._queue


@pytest.mark.parametrize("store", ["packed_bitmap", "perfect_hash"])
def test_runner_encode_block_and_count_block_match_reference(store):
    """The runner's delta path: ``encode_block`` of raw-id chunks (ragged
    widths, items outside the map, an empty basket) over a frequent-item
    map, then ``count_block_async``, equal to the reference's."""
    db = _chunk_db(seed=7)
    raw, _ = padded_from_transactions(db)
    item_map = np.array([0, 2, 3, 5, 8, 13, 21, 29], np.int64)
    t_run = TRunner(store=store, block_n=16, cand_block=8, device="cpu")
    j_run = JRunner(store=store, block_n=16, cand_block=8)
    cand = np.array([[0, 1], [1, 4], [2, 3], [0, 7], [5, 6], [3, 4], [1, 2],
                     [4, 5], [6, 7], [0, 2]], np.int32)
    total = 0
    for lo, hi in ((0, 40), (40, 41), (41, 120)):
        t_enc = t_run.encode_block(raw[lo:hi], item_map)
        j_enc = j_run.encode_block(raw[lo:hi], item_map)
        np.testing.assert_array_equal(t_enc.padded, j_enc.padded)
        np.testing.assert_array_equal(t_enc.bitmap, j_enc.bitmap)
        got = t_run.count_block_async(t_enc, cand).result()
        np.testing.assert_array_equal(
            got, j_run.count_block_async(j_enc, cand).result())
        total += got.sum()
    assert total > 0


# -- the chunked mine --------------------------------------------------------------

_MEM = {}


def _in_memory(store, db):
    if store not in _MEM:
        _MEM[store] = TMiner(min_support=MIN_SUPPORT, store=store,
                             max_k=MAX_K, device="cpu").mine(db)
    return _MEM[store]


def _levels(res):
    return [(p.k, p.n_candidates, p.n_frequent, p.chunks) for p in res.levels]


@pytest.mark.parametrize("store,use_kernel", MINE_CONFIGS)
@pytest.mark.parametrize("inflight", [0, 1, None])
def test_chunked_mine_matches_reference_and_in_memory(
        tmp_path, store, use_kernel, inflight, monkeypatch):
    """Streaming the DB in >= 4 chunks (a ragged last one) mines the same
    itemsets AND supports as the reference's chunked mine and the port's
    in-memory mine; every level streamed every chunk."""
    if use_kernel:
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", True)
    db = _chunk_db()
    path = _write_db(tmp_path, db)
    t_reader, j_reader = _readers(path, chunk_transactions=len(db) // 5 + 1)
    assert t_reader.n_chunks >= 4 and len(db) % t_reader.chunk_transactions
    got = TMiner(min_support=MIN_SUPPORT, store=store, max_k=MAX_K,
                 inflight=inflight, block_n=8, cand_block=64,
                 device="cpu").mine(t_reader)
    want = JMiner(min_support=MIN_SUPPORT, store=store, max_k=MAX_K,
                  inflight=inflight).mine(j_reader)
    mem = _in_memory(store, db)
    assert got.itemsets == want.itemsets == mem.itemsets
    assert len(got.itemsets) > 300 and got.max_k >= 3
    assert (got.n_transactions, got.min_count) == \
        (want.n_transactions, want.min_count) == \
        (mem.n_transactions, mem.min_count)
    np.testing.assert_array_equal(got.item_map, want.item_map)
    assert _levels(got) == _levels(want)
    assert all(p.chunks == t_reader.n_chunks for p in got.levels)
    assert all(p.chunks == 0 for p in mem.levels)


@pytest.mark.parametrize("strategy", ["fpc", "dpc"])
def test_chunked_combined_strategies_match_reference(tmp_path, strategy):
    """FPC and DPC leave several chunked jobs outstanding at once."""
    db = _chunk_db(seed=4)
    path = _write_db(tmp_path, db)
    t_reader, j_reader = _readers(path, chunk_transactions=25)
    got = TMiner(min_support=MIN_SUPPORT, store="packed_bitmap",
                 strategy=strategy, max_k=MAX_K, device="cpu").mine(t_reader)
    want = JMiner(min_support=MIN_SUPPORT, store="packed_bitmap",
                  strategy=strategy, max_k=MAX_K).mine(j_reader)
    assert got.itemsets == want.itemsets
    assert _levels(got) == _levels(want)


def test_chunked_mine_of_empty_file(tmp_path):
    path = str(tmp_path / "empty.dat")
    write_dat(path, [])
    got = TMiner(min_support=MIN_SUPPORT, device="cpu").mine(
        ChunkedDatasetReader(path))
    want = JMiner(min_support=MIN_SUPPORT).mine(
        J_chunked.ChunkedDatasetReader(path))
    assert got.itemsets == want.itemsets == {}
    assert _levels(got) == _levels(want)


def test_device_loop_refuses_a_reader(tmp_path):
    reader = ChunkedDatasetReader(_write_db(tmp_path, _chunk_db()),
                                  chunk_transactions=32)
    miner = TMiner(min_support=MIN_SUPPORT, device_loop=True, device="cpu")
    with pytest.raises(ValueError, match="device_loop=False"):
        miner.mine(reader)
