"""PyTorch port vs JAX package: the five stores (the kernel stores with the
switch at None, True and False) on the store-property suite's databases
(k = 1..4), every store's device-built transaction tensors, and the packed
encoders' bit identity.  Counts are integers: every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.itemsets import level_to_matrix  # noqa: E402
from repro.core.runtime.engine import MapReduceEngine as JEngine  # noqa: E402
from repro.core.stores import ARRAY_STORES as J_STORES  # noqa: E402
from repro.core.stores import encode_db as j_encode_db  # noqa: E402
from repro.core.stores import pack_bitmap as j_pack_bitmap  # noqa: E402
from repro.core.stores.bitmap import BitmapMXUStore as JBitmap  # noqa: E402
from repro.core.stores.bitmap import candidates_to_khot as j_candidates_to_khot  # noqa: E402
from repro.core.stores.packed_bitmap import (  # noqa: E402
    pack_candidates_device as j_pack_candidates,
)
from test_store_properties import EDGE_DBS, _candidates, _random_db  # noqa: E402

from repro_torch.core.runtime.engine import MapReduceEngine as TEngine  # noqa: E402
from repro_torch.core.stores import (  # noqa: E402
    ARRAY_STORES, encoded_db_from_numpy, pack_bitmap, pad_candidates,
)
from repro_torch.core.stores.bitmap import BitmapMXUStore, candidates_to_khot  # noqa: E402
from repro_torch.core.stores.packed_bitmap import (  # noqa: E402
    PackedBitmapStore, pack_candidates_device,
)

MAX_K = 4
CASES = [("seed", s) for s in (0, 1, 2)] + [("edge", i) for i in range(len(EDGE_DBS))]
CONFIGS = [("perfect_hash", None), ("sorted_prefix", None),
           ("hash_bucket", None), ("bitmap", None), ("bitmap", False),
           ("bitmap", True), ("packed_bitmap", None), ("packed_bitmap", False),
           ("packed_bitmap", True)]
_REF = {}  # (store, case) -> {k: counts}, shared by the kernel on/off runs


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and their thread pools would oversubscribe the
    cores at these small shapes (other port test files import this)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _switch(monkeypatch, store, use_kernel):
    """Set a kernel store's switch (None is its default)."""
    cls = ARRAY_STORES[store]
    if hasattr(cls, "use_kernel"):
        monkeypatch.setattr(cls, "use_kernel", use_kernel)
    return cls


def _db(case):
    kind, i = case
    return _random_db(i) if kind == "seed" else EDGE_DBS[i]


def _reference_counts(store, case):
    """The JAX engine's counts for every k (its plain store path)."""
    if (store, case) not in _REF:
        n_items, db = _db(case)
        engine = JEngine(store=store, block_n=16, cand_block=64)
        engine.place(j_encode_db(db, n_items=n_items))
        _REF[(store, case)] = {
            k: engine.count_candidates(level_to_matrix(_candidates(db, k)))
            for k in range(1, MAX_K + 1) if _candidates(db, k)}
    return _REF[(store, case)]


@pytest.mark.parametrize("store,use_kernel", CONFIGS)
@pytest.mark.parametrize("case", CASES)
def test_store_counts_match_reference(store, use_kernel, case, monkeypatch):
    """The same encoded DB (handed over as numpy) through both engines; the
    port also counts each wave with one direct ``count_block`` call."""
    cls = _switch(monkeypatch, store, use_kernel)
    n_items, db = _db(case)
    jenc = j_encode_db(db, n_items=n_items)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    engine = TEngine(store=store, block_n=16, cand_block=64, device="cpu")
    engine.place(enc)
    want = _reference_counts(store, case)
    for k, counts in want.items():
        cand = level_to_matrix(_candidates(db, k))
        np.testing.assert_array_equal(engine.count_candidates(cand), counts,
                                      err_msg=f"{store} kernel={use_kernel} k={k}")
        if enc.n_transactions:
            trans = {n: torch.from_numpy(v)
                     for n, v in cls.transaction_inputs(enc).items()}
            cands = cls.encode_candidates(
                torch.from_numpy(pad_candidates(cand, enc.f_pad)),
                f_pad=enc.f_pad)
            direct = cls.count_block(trans, cands)
            assert direct.dtype == torch.int32
            np.testing.assert_array_equal(direct.numpy()[: len(counts)], counts)


@pytest.mark.parametrize("store", list(ARRAY_STORES))
@pytest.mark.parametrize("case", CASES)
def test_device_transaction_inputs_match(store, case):
    """Each store's device-built transaction tensors equal its host ones
    and the JAX store's device-built ones (as numpy), bit for bit: the
    packed words' sign bit, the ITEM_PAD tail and the -1 pad hashes too."""
    cls = ARRAY_STORES[store]
    n_items, db = _db(case)
    jenc = j_encode_db(db, n_items=n_items)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    bitmap = jenc.bitmap.copy()
    if bitmap.shape[0]:
        bitmap[:, 31] = 1  # bit 31 of word 0: the int32 sign bit
    padded_t = torch.from_numpy(enc.padded)
    got = cls.device_transaction_inputs(padded_t, torch.from_numpy(bitmap))
    host = cls.transaction_inputs(encoded_db_from_numpy(
        enc.padded, bitmap, enc.n_items))
    want = J_STORES[store].device_transaction_inputs(jnp.asarray(enc.padded),
                                                     jnp.asarray(bitmap))
    assert set(got) == set(host) == set(want)
    for name, t in got.items():
        assert t.dtype == torch.from_numpy(np.asarray(host[name])).dtype
        np.testing.assert_array_equal(t.numpy(), host[name])
        w = np.asarray(want[name])
        np.testing.assert_array_equal(
            t.numpy(), w.view(np.int32) if w.dtype == np.uint32 else w)


@pytest.mark.parametrize("store", ["bitmap", "packed_bitmap"])
def test_default_switch_takes_plain_path_on_cpu(store, monkeypatch):
    """With ``use_kernel`` at its default (None), CPU tensors are encoded in
    the plain path's layout and counted without the kernel's wrapper."""
    from repro_torch.kernels import support_count as kernels

    cls = ARRAY_STORES[store]
    assert cls.use_kernel is None
    assert not cls.kernel_on("cpu") and cls.kernel_on("cuda")

    def refuse(*args):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(kernels, "support_count", refuse)
    monkeypatch.setattr(kernels, "packed_support_count", refuse)
    n_items, db = _random_db(0)
    jenc = j_encode_db(db, n_items=n_items)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    trans = {n: torch.from_numpy(v) for n, v in cls.transaction_inputs(enc).items()}
    cand = pad_candidates(level_to_matrix(_candidates(db, 2)), enc.f_pad)
    cands = cls.encode_candidates(torch.from_numpy(cand), f_pad=enc.f_pad)
    if store == "bitmap":
        assert cands["khot"].dtype == torch.float32
    else:
        assert set(cands) == {"packedT", "kvec"}
    np.testing.assert_array_equal(cls.count_block(trans, cands).numpy()[:len(
        _candidates(db, 2))], _reference_counts(store, ("seed", 0))[2])


@pytest.mark.parametrize("seed", range(4))
def test_pack_bitmap_bit_identical(seed):
    rng = np.random.default_rng(seed)
    n, f = int(rng.integers(1, 40)), 128 * int(rng.integers(1, 4))
    bitmap = (rng.random((n, f)) < 0.5).astype(np.uint8)
    bitmap[:, f - 1] = 1  # the sign bit of the last word
    got = pack_bitmap(bitmap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, j_pack_bitmap(bitmap).view(np.int32))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_pack_candidates_bit_identical(k):
    """Real rows (every bit position, the sign bit included) and pad rows."""
    rng = np.random.default_rng(k)
    f_pad = 256
    cand = np.stack([np.sort(rng.choice(f_pad, k, replace=False))
                     for _ in range(37)]).astype(np.int32)
    cand[0] = np.arange(32 - k, 32)  # reaches bit 31, the int32 sign bit
    cand_p = pad_candidates(cand, f_pad)
    want = np.asarray(j_pack_candidates(jnp.asarray(cand_p), f_pad // 32))
    got = pack_candidates_device(torch.from_numpy(cand_p), f_pad // 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_encode_candidates_layouts(use_kernel, monkeypatch):
    """Each store emits the layout its active path reads (None on CPU
    tensors: the plain one), and every tensor it returns is named by
    ``candidate_shard_axes`` with its C axis."""
    monkeypatch.setattr(PackedBitmapStore, "use_kernel", use_kernel)
    monkeypatch.setattr(BitmapMXUStore, "use_kernel", use_kernel)
    rng = np.random.default_rng(9)
    f_pad = 256
    cand = pad_candidates(np.stack([np.sort(rng.choice(200, 3, replace=False))
                                    for _ in range(17)]).astype(np.int32), f_pad)
    jk = JBitmap.encode_candidates(jnp.asarray(cand), f_pad=f_pad)
    bk = BitmapMXUStore.encode_candidates(torch.from_numpy(cand), f_pad=f_pad)
    kernel = bool(use_kernel)
    assert bk["khot"].dtype == (torch.int8 if kernel else torch.float32)
    np.testing.assert_array_equal(bk["khot"].float().numpy(), np.asarray(jk["khot"]))
    np.testing.assert_array_equal(bk["kvec"].numpy(), np.asarray(jk["kvec"]))
    host_khot, host_kvec = candidates_to_khot(cand, f_pad)
    want_khot, want_kvec = j_candidates_to_khot(cand, f_pad)
    np.testing.assert_array_equal(host_khot, want_khot)
    np.testing.assert_array_equal(host_kvec, want_kvec)
    pk = PackedBitmapStore.encode_candidates(torch.from_numpy(cand), f_pad=f_pad)
    assert set(pk) == {"packed" if kernel else "packedT", "kvec"}
    for cls in ARRAY_STORES.values():
        out = cls.encode_candidates(torch.from_numpy(cand), f_pad=f_pad)
        axes = cls.candidate_shard_axes()
        assert set(out) == set(axes)
        for name, axis in axes.items():
            assert out[name].shape[axis] == cand.shape[0]


@pytest.mark.parametrize("store,use_kernel", CONFIGS)
def test_apply_delta_is_signed_count_block(store, use_kernel, monkeypatch):
    cls = _switch(monkeypatch, store, use_kernel)
    n_items, db = _random_db(1)
    jenc = j_encode_db(db, n_items=n_items)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    trans = {n: torch.from_numpy(v) for n, v in cls.transaction_inputs(enc).items()}
    cand = pad_candidates(level_to_matrix(_candidates(db, 2)), enc.f_pad)
    cands = cls.encode_candidates(torch.from_numpy(cand), f_pad=enc.f_pad)
    base = torch.arange(cand.shape[0], dtype=torch.int64)
    up = cls.apply_delta(base, trans, cands, +1)
    assert up.dtype == torch.int64
    torch.testing.assert_close(up - base, cls.count_block(trans, cands).long())
    torch.testing.assert_close(cls.apply_delta(up, trans, cands, -1), base)


def test_pad_transactions_to_matches_reference():
    n_items, db = _random_db(2)
    jenc = j_encode_db(db, n_items=n_items)
    enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
    enc.packed  # the cached packed view is extended too
    n = enc.n_transactions + 5
    got, want = enc.pad_transactions_to(n), jenc.pad_transactions_to(n)
    np.testing.assert_array_equal(got.padded, want.padded)
    np.testing.assert_array_equal(got.bitmap, want.bitmap)
    np.testing.assert_array_equal(got.packed, want.packed.view(np.int32))
    assert enc.pad_transactions_to(enc.n_transactions) is enc
