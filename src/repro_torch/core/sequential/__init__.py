"""CPU implementations of the paper's three candidate stores.

These mirror the Java classes described in §4 of the paper (InnerNode/LeafNode
hash tree, linear-search TrieNode trie, and the hash-table trie).  They are
the mapper structures of ``SimRunner`` (the paper's Hadoop cluster model) and
correctness oracles for the array-layout stores.  Pure Python: a mapper in a
pool worker needs neither torch nor a device to build or count them.
"""

from repro_torch.core.sequential.hashtree import HashTree
from repro_torch.core.sequential.trie import Trie
from repro_torch.core.sequential.hashtable_trie import HashTableTrie

SEQUENTIAL_STORES = {
    "hash_tree": HashTree,
    "trie": Trie,
    "hash_table_trie": HashTableTrie,
}

__all__ = ["HashTree", "Trie", "HashTableTrie", "SEQUENTIAL_STORES"]
