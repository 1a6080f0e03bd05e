"""Support-count kernels of the PyTorch port.

On the CPU the port's wrappers compute with the plain versions (``ref.py``);
those are held exactly against the JAX package's oracles and its Pallas
kernels (interpret mode), on the shape, dtype, block and mixed-k cases of
``test_kernel_support_count.py`` and ``test_packed_store.py``.  The
hand-written CUDA kernels are held against the plain versions on a card in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401

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
    build, launches, packed_support_count, packed_support_count_ref,
    support_count, support_count_ref, tma_operands,
)

BITMAP_SHAPES = [(8, 16, 4, 1), (100, 130, 70, 2), (256, 128, 128, 3),
                 (513, 257, 300, 5), (64, 512, 1024, 4), (1200, 96, 33, 7)]
PACKED_SHAPES = [(8, 4, 4, 1), (100, 5, 70, 2), (256, 8, 128, 3),
                 (513, 9, 300, 5), (64, 16, 1024, 4)]


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


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.kernel("packed_support_count")
