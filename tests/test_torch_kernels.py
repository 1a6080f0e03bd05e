"""Support-count kernels of the PyTorch port.

On the CPU the port's wrappers compute with the plain versions (``ref.py``);
those are held exactly against the JAX package's oracles and its Pallas
kernels (interpret mode), on the shape, dtype, block and mixed-k cases of
``test_kernel_support_count.py`` and ``test_packed_store.py``, and the
gather-AND-popcount's against the JAX ``perfect_hash`` store's count.  The
hand-written CUDA kernels are held against the plain versions on a card in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401

from repro.core.stores import ARRAY_STORES as J_STORES  # noqa: E402
from repro.core.stores import pack_bitmap as j_pack_bitmap  # noqa: E402
from repro.core.stores.packed_bitmap import (  # noqa: E402
    pack_candidates_device as j_pack_candidates,
)
from repro.kernels.support_count import (  # noqa: E402
    packed_support_count as j_packed_pallas,
    packed_support_count_ref as j_packed_ref,
    support_count as j_pallas,
    support_count_ref as j_ref,
)

from repro_torch.kernels.support_count import (  # noqa: E402
    build, gather_and_count, gather_and_count_bits, gather_and_count_pack,
    gather_and_count_ref, gather_and_count_words, launches,
    packed_support_count, packed_support_count_ref, packed_variant,
    support_count, support_count_ref, tma_operands,
)

BITMAP_SHAPES = [(8, 16, 4, 1), (100, 130, 70, 2), (256, 128, 128, 3),
                 (513, 257, 300, 5), (64, 512, 1024, 4), (1200, 96, 33, 7)]
PACKED_SHAPES = [(8, 4, 4, 1), (100, 5, 70, 2), (256, 8, 128, 3),
                 (513, 9, 300, 5), (64, 16, 1024, 4)]
# (Nb, F_pad, C, k, pad rows): ragged row counts around a 32-row word,
# k 1-5, C 0 and 1, and pad rows (every item f_pad - 1).
GATHER_SHAPES = [(1, 128, 1, 1, 0), (31, 128, 40, 2, 3), (33, 256, 129, 3, 9),
                 (2049, 200, 64, 4, 4), (64, 130, 0, 2, 0), (100, 96, 1, 5, 0),
                 (33, 64, 50, 1, 50)]


def _bitmap_case(n, f, c, k, seed):
    rng = np.random.default_rng(seed)
    bitmap = (rng.random((n, f)) < 0.3).astype(np.float32)
    khot = np.zeros((c, f), np.float32)
    for i in range(c):
        khot[i, rng.choice(f, k, replace=False)] = 1.0
    return bitmap, khot, np.full(c, k, np.int32)


def _mixed_bitmap_case(f=64, n=128, pads=5):
    """Mixed k in one call (FPC waves) plus kvec=-1 pad rows."""
    rng = np.random.default_rng(5)
    bitmap = (rng.random((n, f)) < 0.4).astype(np.float32)
    rows = [rng.choice(f, k, replace=False) for k in (2, 3, 4) for _ in range(10)]
    khot = np.zeros((len(rows), f), np.float32)
    kvec = np.zeros(len(rows), np.int32)
    for i, row in enumerate(rows):
        khot[i, row] = 1.0
        kvec[i] = len(row)
    kvec[-pads:] = -1
    return bitmap, khot, kvec


def _packed_case(n, w, c, ks, seed, pads=0):
    rng = np.random.default_rng(seed)
    f = w * 32
    bitmap = np.zeros((n, f), np.uint8)
    bitmap[:, : f - 1] = rng.random((n, f - 1)) < 0.35
    rows = [np.sort(rng.choice(f - 1, ks[i % len(ks)], replace=False))
            for i in range(c)]
    cpacked = np.concatenate([
        np.asarray(j_pack_candidates(jnp.asarray(r[None, :].astype(np.int32)), w))
        for r in rows])
    kvec = np.array([len(r) for r in rows], np.int32)
    if pads:
        kvec[-pads:] = -1
    return j_pack_bitmap(bitmap), cpacked, kvec


def _t(a, dtype=None):
    """numpy -> torch; uint32 words become int32 with the same bits."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _gather_case(n, f, c, k, pads, seed):
    """{0,1} rows with the always-zero pad column f - 1, and (C, k) sorted
    distinct item ids below it, the first held by row 0; the last ``pads``
    rows are pad rows."""
    rng = np.random.default_rng(seed)
    bitmap = (rng.random((n, f)) < 0.45).astype(np.uint8)
    bitmap[:, f - 1] = 0
    cand = np.stack([np.sort(rng.choice(f - 1, k, replace=False))
                     for _ in range(c)]) if c else np.zeros((0, k))
    cand = cand.astype(np.int32)
    if c > pads:
        bitmap[0, cand[0]] = 1  # at least one real candidate is matched
    if pads:
        cand[-pads:] = f - 1
    return bitmap, cand


# -- plain versions on the CPU vs the JAX oracles and Pallas kernels --------

@pytest.mark.parametrize("n,f,c,k", BITMAP_SHAPES)
def test_support_count_plain_matches_pallas(n, f, c, k):
    bitmap, khot, kvec = _bitmap_case(n, f, c, k, seed=n * 7 + c)
    want = np.asarray(j_pallas(bitmap, khot, kvec, block_n=128, block_c=128,
                               block_f=128, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(j_ref(jnp.array(bitmap), jnp.array(khot), jnp.array(kvec))), want)
    got = support_count(_t(bitmap), _t(khot), _t(kvec))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int8, np.uint8])
def test_support_count_plain_dtypes(dtype):
    bitmap, khot, kvec = _bitmap_case(96, 64, 40, 3, seed=3)
    want = np.asarray(j_ref(jnp.array(bitmap), jnp.array(khot), jnp.array(kvec)))
    got = support_count_ref(_t(bitmap.astype(dtype)), _t(khot.astype(dtype)),
                            _t(kvec))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blocks", [(64, 64, 64), (128, 256, 64), (512, 512, 512)])
def test_support_count_plain_vs_pallas_blocks(blocks):
    bn, bc, bf = blocks
    bitmap, khot, kvec = _bitmap_case(200, 140, 180, 4, seed=11)
    want = np.asarray(j_pallas(bitmap, khot, kvec, block_n=bn, block_c=bc,
                               block_f=bf, interpret=True))
    np.testing.assert_array_equal(
        support_count(_t(bitmap), _t(khot), _t(kvec)).numpy(), want)


def test_support_count_plain_mixed_k_and_pads():
    bitmap, khot, kvec = _mixed_bitmap_case()
    want = np.asarray(j_pallas(bitmap, khot, kvec, block_n=64, block_c=64,
                               block_f=64, interpret=True))
    np.testing.assert_array_equal(
        support_count(_t(bitmap), _t(khot), _t(kvec)).numpy(), want)
    assert (support_count(_t(bitmap), _t(khot), _t(kvec)).numpy()[-5:] == 0).all()


@pytest.mark.parametrize("n,f,c,k,misalign", [
    (513, 257, 300, 5, 0), (100, 130, 70, 2, 0), (64, 1, 8, 1, 0),
    (1200, 96, 33, 7, 0), (200, 128, 90, 3, 8)])
def test_tma_operands_keep_counts(n, f, c, k, misalign):
    """The CUDA wrapper's copy into TMA's layout (F up to a multiple of 16,
    16-byte-aligned rows) leaves every count as the Pallas kernel has it."""
    bitmap, khot, kvec = _bitmap_case(n, f, c, k, seed=n + f)
    want = np.asarray(j_pallas(bitmap, khot, kvec, block_n=128, block_c=128,
                               block_f=128, interpret=True))
    b8 = _t(bitmap, torch.uint8)
    if misalign:  # the same rows at an address 8 bytes past a 16-byte granule
        buf = torch.zeros(n * f + 64, dtype=torch.uint8)
        start = (-buf.data_ptr()) % 16 + misalign
        b8 = buf[start:start + n * f].view(n, f).copy_(b8)
    pb, pk, copied = tma_operands(b8, _t(khot, torch.int8))
    assert copied == bool(f % 16 or misalign)
    f16 = pb.shape[1]
    assert pk.shape == (c, f16) and f16 % 16 == 0 and f <= f16 < f + 16
    assert pb.data_ptr() % 16 == 0 and pk.data_ptr() % 16 == 0
    assert not pb[:, f:].any() and not pk[:, f:].any()
    assert pb.dtype == torch.uint8 and pk.dtype == torch.int8
    np.testing.assert_array_equal(
        support_count(pb, pk, _t(kvec)).numpy(), want)


@pytest.mark.parametrize("n,w,c,k", PACKED_SHAPES)
def test_packed_plain_matches_pallas(n, w, c, k):
    packed, cpacked, kvec = _packed_case(n, w, c, [k], seed=n * 31 + c)
    want = np.asarray(j_packed_pallas(packed, cpacked, kvec, block_n=128,
                                      block_c=128, block_w=4, interpret=True))
    np.testing.assert_array_equal(np.asarray(j_packed_ref(packed, cpacked, kvec)), want)
    got = packed_support_count(_t(packed), _t(cpacked), _t(kvec))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,w,c,k,misalign", [
    (100, 5, 70, 2, 0), (513, 9, 300, 5, 0), (40, 1, 20, 1, 0),
    (64, 21, 90, 3, 0), (200, 16, 90, 3, 8), (64, 20, 40, 4, 0)])
def test_packed_tma_operands_keep_counts(n, w, c, k, misalign):
    """The packed kernel's operands go through the same copy into TMA's
    layout: W up to a multiple of 4 words, 16-byte-aligned rows; the zero
    words leave every count as the Pallas kernel has it."""
    packed, cpacked, kvec = _packed_case(n, w, c, [k], seed=n + w)
    want = np.asarray(j_packed_pallas(packed, cpacked, kvec, block_n=128,
                                      block_c=128, block_w=4, interpret=True))
    words = _t(packed)
    if misalign:  # the same rows at an address 8 bytes past a 16-byte granule
        buf = torch.zeros(n * w + 16, dtype=torch.int32)
        start = ((-buf.data_ptr()) % 16 + misalign) // 4
        words = buf[start:start + n * w].view(n, w).copy_(words)
    pw, pc, copied = tma_operands(words, _t(cpacked))
    assert copied == bool(w % 4 or misalign)
    w4 = pw.shape[1]
    assert pc.shape == (c, w4) and w4 % 4 == 0 and w <= w4 < w + 4
    assert pw.data_ptr() % 16 == 0 and pc.data_ptr() % 16 == 0
    assert not pw[:, w:].any() and not pc[:, w:].any()
    assert pw.dtype == pc.dtype == torch.int32
    np.testing.assert_array_equal(
        packed_support_count(pw, pc, _t(kvec)).numpy(), want)
    assert packed_variant(w) == ("resident" if w4 <= 20 else "streamed")


def _spread_bytes(words: np.ndarray) -> np.ndarray:
    """(rows, 32 W) uint8: the packed kernel's unpacking, modelled in numpy.
    Each nibble of a word becomes four {0,1} bytes as
    (nib * 0x00204081) & 0x01010101, little-endian: bit b of word j is byte
    32 j + b, the same map for rows and candidates."""
    words = words.astype(np.uint32)
    nibs = (words[..., None] >> (4 * np.arange(8, dtype=np.uint32))) & 15
    four = (nibs * np.uint32(0x00204081)) & np.uint32(0x01010101)
    return four.astype("<u4").view(np.uint8).reshape(words.shape[0], -1)


@pytest.mark.parametrize("n,w,c,ks", [(90, 6, 50, [1, 2, 3, 4]),
                                      (64, 5, 40, [7]), (33, 21, 20, [2, 9])])
def test_unpacked_int8_dot_is_the_and_popcount(n, w, c, ks):
    """What the tensor-core kernel computes: the int8 dot of the unpacked
    bits of a row and a candidate equals their AND-popcount, dense words
    and the sign bit included, so the compare with kvec gives the Pallas
    kernel's counts."""
    rng = np.random.default_rng(n * w)
    packed = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    cpacked = rng.integers(0, 2 ** 32, (c, w), dtype=np.uint32)
    packed[::3, 0] |= np.uint32(1 << 31)
    cpacked[::2, -1] |= np.uint32(1 << 31)
    rows, cands = _spread_bytes(packed), _spread_bytes(cpacked)
    assert rows.shape == (n, 32 * w) and set(np.unique(rows)) <= {0, 1}
    dots = rows.astype(np.int32) @ cands.astype(np.int32).T
    kvec = dots[rng.integers(n, size=c), np.arange(c)].astype(np.int32)
    want = np.asarray(j_packed_pallas(packed, cpacked, kvec, block_n=128,
                                      block_c=128, block_w=4, interpret=True))
    np.testing.assert_array_equal((dots == kvec[None, :]).sum(0), want)
    np.testing.assert_array_equal(
        packed_support_count(_t(packed), _t(cpacked), _t(kvec)).numpy(), want)
    assert want.min() >= 1  # each kvec is some row's true count


@pytest.mark.parametrize("n,f,c,k,pads", GATHER_SHAPES)
def test_gather_and_count_plain_matches_store(n, f, c, k, pads):
    """The plain version and the wrapper on CPU tensors equal the JAX
    package's ``perfect_hash`` count and a row-by-row count of the rows
    holding every item; pad rows count 0."""
    bitmap, cand = _gather_case(n, f, c, k, pads, seed=n * 13 + c)
    want = np.asarray(J_STORES["perfect_hash"].count_block(
        {"bitmap": jnp.asarray(bitmap)}, {"cand": jnp.asarray(cand)}))
    rows = bitmap[:, cand].astype(bool).all(axis=2).sum(axis=0)
    np.testing.assert_array_equal(want, rows)
    for fn in (gather_and_count_ref, gather_and_count):
        got = fn(_t(bitmap), _t(cand))
        assert got.dtype == torch.int32 and got.shape == (c,)
        np.testing.assert_array_equal(got.numpy(), want)
    if pads:
        assert not want[-pads:].any()
    if c > pads:
        assert want[:c - pads].sum() > 0


def test_packed_plain_mixed_k_pads_and_sign_bit():
    """Mixed k with pad rows, and words whose top bit is set (negative as
    int32): the popcount must see the 32 bits, not the sign."""
    packed, cpacked, kvec = _packed_case(90, 6, 50, [1, 2, 3, 4], seed=4, pads=6)
    packed = packed | np.uint32(1 << 31)
    cpacked[::3, 0] |= np.uint32(1 << 31)
    want = np.asarray(j_packed_ref(packed, cpacked, kvec))
    got = packed_support_count_ref(_t(packed), _t(cpacked), _t(kvec))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[: len(want) - 6].sum() > 0


# -- wrapper contract ---------------------------------------------------------

def test_cpu_inputs_use_plain_version_without_launch():
    before = dict(launches)
    packed, cpacked, kvec = _packed_case(40, 4, 20, [2], seed=1)
    packed_support_count(_t(packed), _t(cpacked), _t(kvec))
    bitmap, khot, kv = _bitmap_case(40, 64, 20, 2, seed=1)
    support_count(_t(bitmap), _t(khot), _t(kv))
    rows, cand = _gather_case(40, 64, 20, 2, 0, seed=1)
    gather_and_count(_t(rows), _t(cand))
    assert dict(launches) == before


def test_no_fallback_for_other_devices():
    """A tensor on a device with no kernel raises instead of computing, and
    inputs split across devices raise."""
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    kv = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        packed_support_count(meta, torch.empty((3, 2), dtype=torch.int32,
                                               device="meta"), kv)
    with pytest.raises(ValueError, match="different devices"):
        support_count(torch.zeros((4, 8)), meta, kv)
    with pytest.raises(ValueError, match="no kernel"):
        gather_and_count(meta.to(torch.uint8), torch.empty(
            (3, 2), dtype=torch.int32, device="meta"))


def test_kernel_words_are_made_only_on_a_card():
    """Kernel 3's packed words have no plain version: both halves raise on
    CPU tensors (the plain count reads the bitmap), and on a device with no
    kernel, without a launch; a column holds 16-byte vectors of words."""
    rows, cand = _gather_case(40, 64, 20, 2, 0, seed=1)
    before = dict(launches)
    with pytest.raises(ValueError, match="CUDA device"):
        gather_and_count_pack(_t(rows))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_and_count_bits(torch.zeros((64, 4), dtype=torch.int32), 40,
                              _t(cand))
    with pytest.raises(ValueError, match="no kernel"):
        gather_and_count_pack(torch.empty((40, 64), dtype=torch.uint8,
                                          device="meta"))
    assert dict(launches) == before
    assert [gather_and_count_words(n) for n in (0, 1, 128, 129, 2 ** 20)] == [
        0, 4, 4, 8, 32_768]


@pytest.mark.parametrize("name", list(build.KERNELS))
def test_c_entry_point_is_in_its_source(name):
    """Every launch counter names a C entry of a source in ``csrc/``, whose
    parameters match the ctypes argument types it is loaded with."""
    source, symbol, argtypes = build.KERNELS[name]
    assert source in build.SOURCES
    text = (build.CSRC / f"{source}.cu").read_text()
    head = f'extern "C" int {symbol}('
    assert text.count(head) == 1
    params = text[text.index(head) + len(head):].split(")", 1)[0]
    assert len(params.split(",")) == len(argtypes)
    assert name in launches


@pytest.mark.parametrize("name", list(build.KERNELS))
def test_missing_compiler_raises(monkeypatch, tmp_path, name):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.kernel(name)
