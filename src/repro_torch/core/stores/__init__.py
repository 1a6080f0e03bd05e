"""Array-layout candidate stores (PyTorch port).

=================  =====================  ==============================================
paper structure    store                  per-level matching primitive
=================  =====================  ==============================================
hash-table trie    ``perfect_hash``       one gather into the transaction bitmap; on the
                                          card a kernel ANDs bit-packed columns
trie               ``sorted_prefix``      binary search in the sorted transaction
hash tree          ``hash_bucket``        bucket probe + linear scan over the bucket
(beyond paper)     ``bitmap``             dense (T·Cᵀ == k) product, int8 tensor cores
(beyond paper)     ``packed_bitmap``      popcount(t & c) == k over 32-items/word
=================  =====================  ==============================================

``perfect_hash``, ``bitmap`` and ``packed_bitmap`` count through hand-written
CUDA kernels on the card (``repro_torch.kernels.support_count``:
``gather_and_count``, ``support_count``, ``packed_support_count``) and
through plain PyTorch on the CPU; ``use_kernel`` forces either path.

Every store implements ``count_block(trans_block, cands) -> int32[C]`` over
a block of transaction tensors, and all produce identical counts.  Candidate
tensors are built on the device by ``encode_candidates(cand, f_pad=...)``
from the small (C, k) int32 matrix, the only per-wave host-to-device
transfer.  ``device_transaction_inputs(padded, bitmap)`` builds a store's
transaction tensors on the device from an encoding's padded ids and bitmap,
and nothing else builds them: the placed DB, ad-hoc blocks and the level
ladder's trims all go through it.
"""

from repro_torch.core.stores.base import (
    DeltaCountMixin, EncodedDB, KernelSwitchMixin, dense_remap_padded, encode_db,
    encode_db_from_padded, encoded_db_from_numpy, pack_bitmap, pad_candidates,
    padded_from_transactions, tracked_keep_mask, ITEM_PAD, WORD_BITS,
)
from repro_torch.core.stores.perfect_hash import PerfectHashStore
from repro_torch.core.stores.sorted_prefix import SortedPrefixStore
from repro_torch.core.stores.hash_bucket import HashBucketStore
from repro_torch.core.stores.bitmap import BitmapMXUStore
from repro_torch.core.stores.packed_bitmap import PackedBitmapStore

ARRAY_STORES = {
    "perfect_hash": PerfectHashStore,
    "sorted_prefix": SortedPrefixStore,
    "hash_bucket": HashBucketStore,
    "bitmap": BitmapMXUStore,
    "packed_bitmap": PackedBitmapStore,
}

__all__ = [
    "DeltaCountMixin",
    "EncodedDB",
    "KernelSwitchMixin",
    "dense_remap_padded",
    "encode_db",
    "encode_db_from_padded",
    "encoded_db_from_numpy",
    "padded_from_transactions",
    "pack_bitmap",
    "pad_candidates",
    "tracked_keep_mask",
    "ITEM_PAD",
    "WORD_BITS",
    "PerfectHashStore",
    "SortedPrefixStore",
    "HashBucketStore",
    "BitmapMXUStore",
    "PackedBitmapStore",
    "ARRAY_STORES",
]
