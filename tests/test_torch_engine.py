"""PyTorch port vs JAX package: the single-device counting engine.

Job1 histograms and ``count_candidates`` at ``inflight`` 0, 1 and None
(auto-sized), with ``cand_block`` smaller than the wave and a ragged
``block_n`` tail, against ``MapReduceEngine`` on the same encoded DB; and
the rows each ``count_block`` call gets: all of them where the store
counts whole rows, ``block_n``-row blocks and a tail otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.itemsets import apriori_gen_matrix  # noqa: E402
from repro.core.runtime.engine import MapReduceEngine as JEngine  # noqa: E402
from repro.core.stores import encode_db as j_encode_db  # noqa: E402
from repro.core.stores import padded_from_transactions as j_padded  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401

from repro_torch.core.runtime.engine import MapReduceEngine as TEngine  # noqa: E402
from repro_torch.core.stores import (  # noqa: E402
    ARRAY_STORES, PerfectHashStore, encoded_db_from_numpy)

N_ITEMS = 40
_REF = {}


def _db(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return [sorted(set(rng.integers(0, N_ITEMS, int(rng.integers(0, 12))).tolist()))
            for _ in range(n)]


def _wave():
    """Every 2- and 3-item candidate over the first items: C2 + C3."""
    c2 = apriori_gen_matrix(np.arange(N_ITEMS, dtype=np.int32)[:, None])
    return c2, apriori_gen_matrix(c2[:300])


def _reference(store):
    if store not in _REF:
        engine = JEngine(store=store, block_n=64, cand_block=128)
        engine.place(j_encode_db(_db(), n_items=N_ITEMS))
        _REF[store] = [engine.count_candidates(c) for c in _wave()]
    return _REF[store]


@pytest.mark.parametrize("inflight", [0, 1, None])
@pytest.mark.parametrize("store,use_kernel", [("perfect_hash", False),
                                              ("perfect_hash", True),
                                              ("bitmap", True),
                                              ("packed_bitmap", True),
                                              ("packed_bitmap", False)])
def test_count_candidates_matches_reference(store, use_kernel, inflight,
                                            monkeypatch):
    if use_kernel:
        monkeypatch.setattr(ARRAY_STORES[store], "use_kernel", True)
    jenc = j_encode_db(_db(), n_items=N_ITEMS)
    engine = TEngine(store=store, block_n=64, cand_block=128,
                     inflight=inflight, device="cpu")
    engine.place(encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items))
    waves = _wave()
    assert waves[0].shape[0] > 128 and jenc.padded.shape[0] % 64  # chunked, ragged
    for cand, want in zip(waves, _reference(store)):
        got = engine.count_candidates(cand)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    if inflight is None:
        assert 1 <= engine.inflight <= 8  # tuned on the wave's second chunk
    else:
        assert engine.inflight == inflight


@pytest.mark.parametrize("path", ["wave", "block"])
@pytest.mark.parametrize("store,use_kernel,whole", [
    ("perfect_hash", None, True), ("perfect_hash", None, False),
    ("perfect_hash", True, False), ("packed_bitmap", None, False),
    ("bitmap", None, False), ("sorted_prefix", None, False),
    ("hash_bucket", None, False)])
def test_count_block_rows_per_call(store, use_kernel, whole, path,
                                   monkeypatch):
    """A store that counts whole rows (forced here on the CPU, as the
    ``perfect_hash`` kernel reports it on the card) gets one ``count_block``
    call a candidate chunk with all N rows; every other store, and
    ``perfect_hash`` on its plain path or with its kernel forced on CPU
    tensors, gets ceil(N / ``block_n``) calls, the ragged tail included.
    Counts are identical both ways, through the resident wave and through
    ``count_block`` over an ad-hoc block."""
    cls = ARRAY_STORES[store]
    if use_kernel is not None:
        monkeypatch.setattr(cls, "use_kernel", use_kernel)
    if whole:
        monkeypatch.setattr(PerfectHashStore, "counts_whole_rows",
                            classmethod(lambda c, device: True))
    rows, orig = [], cls.count_block

    def logged(trans, cands):
        rows.append(next(iter(trans.values())).shape[0])
        return orig(trans, cands)

    monkeypatch.setattr(cls, "count_block", staticmethod(logged))
    jenc = j_encode_db(_db(), n_items=N_ITEMS)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    engine = TEngine(store=store, block_n=64, cand_block=128, device="cpu")
    n = enc.n_transactions
    per_chunk = [n] if whole else [64] * (n // 64) + [n % 64]
    assert n > 64 and n % 64  # several blocks and a ragged tail
    if path == "wave":
        engine.place(enc)
    for cand, want in zip(_wave(), _reference("perfect_hash")):
        rows.clear()
        got = (engine.count_candidates(cand) if path == "wave"
               else engine.count_block(enc, cand))
        np.testing.assert_array_equal(got, want)
        assert rows == per_chunk * -(-cand.shape[0] // 128)


@pytest.mark.parametrize("path", ["wave", "block"])
def test_block_loop_slices_only_row_inputs(path, monkeypatch):
    """The ``block_n`` loop slices only the store's ``row_inputs`` and takes
    N from them: a ``perfect_hash`` tensor of another layout built beside
    the bitmap (as the card's packed words, (F_pad, words)) never reaches a
    block, and the counts stay exact."""
    built = PerfectHashStore.device_transaction_inputs

    def with_words(padded, bitmap):
        trans = built(padded, bitmap)
        return dict(trans, bits=torch.zeros((bitmap.shape[1], 8),
                                            dtype=torch.int32))

    keys, orig = [], PerfectHashStore.count_block

    def logged(trans, cands):
        keys.append((sorted(trans), trans["bitmap"].shape[0]))
        return orig(trans, cands)

    monkeypatch.setattr(PerfectHashStore, "device_transaction_inputs",
                        staticmethod(with_words))
    monkeypatch.setattr(PerfectHashStore, "count_block", staticmethod(logged))
    jenc = j_encode_db(_db(), n_items=N_ITEMS)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    engine = TEngine(store="perfect_hash", block_n=64, cand_block=128,
                     device="cpu")
    n = enc.n_transactions
    if path == "wave":
        engine.place(enc)
        assert set(engine._trans_device) == {"bitmap", "bits"}
    for cand, want in zip(_wave(), _reference("perfect_hash")):
        keys.clear()
        got = (engine.count_candidates(cand) if path == "wave"
               else engine.count_block(enc, cand))
        np.testing.assert_array_equal(got, want)
        per_chunk = [(["bitmap"], 64)] * (n // 64) + [(["bitmap"], n % 64)]
        assert keys == per_chunk * -(-cand.shape[0] // 128)


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_perfect_hash_packs_nothing_on_the_cpu(use_kernel, monkeypatch):
    """On CPU tensors ``perfect_hash`` builds the bitmap alone at every
    switch (its words are made only on a card), and its row tensors are
    that bitmap."""
    monkeypatch.setattr(PerfectHashStore, "use_kernel", use_kernel)
    jenc = j_encode_db(_db(), n_items=N_ITEMS)
    padded, bitmap = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in (jenc.padded, jenc.bitmap))
    trans = PerfectHashStore.device_transaction_inputs(padded, bitmap)
    assert list(trans) == ["bitmap"] and trans["bitmap"] is bitmap
    assert PerfectHashStore.row_inputs(dict(trans, bits=bitmap.T)) == trans
    for name in ("packed_bitmap", "bitmap", "sorted_prefix", "hash_bucket"):
        cls = ARRAY_STORES[name]
        built = cls.device_transaction_inputs(padded, bitmap)
        assert cls.row_inputs(built) is built


@pytest.mark.parametrize("seed", [0, 1])
def test_job1_histogram_matches_reference(seed):
    padded, n_raw = j_padded(_db(seed, n=257))
    want = JEngine().count_items_device(padded, n_raw)
    got = TEngine(device="cpu").count_items_device(padded, n_raw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert TEngine(device="cpu").count_items_device(padded[:0], n_raw).sum() == 0


def test_pipeline_handles_and_abandon():
    """Async handles resolve in FIFO order; ``poll`` drains finished chunks;
    re-placing the DB voids outstanding handles."""
    jenc = j_encode_db(_db(), n_items=N_ITEMS)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    engine = TEngine(block_n=64, cand_block=128, inflight=8, device="cpu")
    engine.place(enc)
    c2, c3 = _wave()
    first = engine.count_candidates_async(c2)
    second = engine.count_candidates_async(c3)
    assert second.poll() and first.done  # CPU results are ready at once
    np.testing.assert_array_equal(first.result(), _reference("perfect_hash")[0])
    pending = engine.count_candidates_async(c2)
    engine.place(enc)
    with pytest.raises(RuntimeError, match="cancelled"):
        pending.result()
    empty = engine.count_candidates_async(np.zeros((0, 2), np.int32))
    assert empty.result().shape == (0,)


@pytest.mark.parametrize("order", ["dispatch", "reverse"])
def test_outstanding_jobs_resolve_independently(order):
    """Several waves of different k outstanding at once in the FIFO (as a
    combined FPC/DPC job dispatches them): resolving a later one fetches the
    earlier ones' chunks into *their* handles, never cancels them, and every
    handle returns its own wave's counts."""
    jenc = j_encode_db(_db(), n_items=N_ITEMS)
    engine = TEngine(store="packed_bitmap", block_n=64, cand_block=128,
                     inflight=64, device="cpu")
    engine.place(encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items))
    c2, c3 = _wave()
    waves = [c2, c3, c2[:5], c3[:130]]
    handles = [engine.count_candidates_async(w) for w in waves]
    assert len(engine._queue) == sum(-(-w.shape[0] // 128) for w in waves)
    ref = _reference("packed_bitmap")
    want = [ref[0], ref[1], ref[0][:5], ref[1][:130]]
    picks = range(4) if order == "dispatch" else reversed(range(4))
    for i in picks:
        np.testing.assert_array_equal(handles[i].result(), want[i])
    assert not engine._queue
    for h, w in zip(handles, want):
        assert not h._cancelled
        np.testing.assert_array_equal(h.result(), w)


def test_empty_db_counts_zero():
    engine = TEngine(store="packed_bitmap", device="cpu")
    jenc = j_encode_db([], n_items=1)
    engine.place(encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items))
    np.testing.assert_array_equal(
        engine.count_candidates(np.array([[0]], np.int32)), [0])
