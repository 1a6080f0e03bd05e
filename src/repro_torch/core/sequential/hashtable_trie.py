"""Hash-table trie — Bodon's trie with per-node hashing [6], paper §2.3.

Identical traversal structure to
:class:`repro_torch.core.sequential.trie.Trie`, but each node resolves its
child in O(1) through a hash table ("perfect hashing have to be maintained
since a leaf in a trie represents exactly one itemset"). The Python dict
plays the role of the per-node perfect hash table the paper's Java
implementation adds to TrieNode.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.core.itemsets import Itemset


class HTrieNode:
    __slots__ = ("children", "count", "terminal")

    def __init__(self) -> None:
        self.children: Dict[int, "HTrieNode"] = {}
        self.count = 0
        self.terminal = False


class HashTableTrie:
    name = "hash_table_trie"

    def __init__(self, candidates: Sequence[Itemset] = ()) -> None:
        self.root = HTrieNode()
        self.k = 0
        for c in candidates:
            self.insert(c)

    def insert(self, itemset: Itemset) -> None:
        node = self.root
        for item in itemset:
            nxt = node.children.get(int(item))
            if nxt is None:
                nxt = HTrieNode()
                node.children[int(item)] = nxt
            node = nxt
        node.terminal = True
        node.count = 0
        self.k = max(self.k, len(itemset))

    def contains(self, itemset: Itemset) -> bool:
        node = self.root
        for item in itemset:
            node = node.children.get(int(item))
            if node is None:
                return False
        return node.terminal

    def count_transaction(self, transaction: Sequence[int]) -> None:
        t = sorted(set(int(x) for x in transaction))
        self._descend(self.root, t, 0, self.k)

    def _descend(self, node: HTrieNode, t: List[int], start: int, remaining: int) -> None:
        if node.terminal and remaining == 0:
            node.count += 1
            return
        if remaining <= 0:
            return
        get = node.children.get
        for i in range(start, len(t) - remaining + 1):
            child = get(t[i])  # O(1) hashed child step
            if child is not None:
                self._descend(child, t, i + 1, remaining - 1)

    def counts(self) -> Dict[Itemset, int]:
        out: Dict[Itemset, int] = {}
        self._collect(self.root, (), out)
        return out

    def _collect(self, node: HTrieNode, prefix: Itemset, out: Dict[Itemset, int]) -> None:
        if node.terminal:
            out[prefix] = node.count
        for item in sorted(node.children):
            self._collect(node.children[item], prefix + (item,), out)

    def generate_candidates(self) -> List[Itemset]:
        out: List[Itemset] = []
        self._gen(self.root, (), self.k - 1, out)
        return out

    def _gen(self, node: HTrieNode, prefix: Itemset, depth: int, out: List[Itemset]) -> None:
        if depth == 0:
            labels = sorted(node.children)
            for a in range(len(labels)):
                for b in range(a + 1, len(labels)):
                    cand = prefix + (labels[a], labels[b])
                    if self._prune_ok(cand):
                        out.append(cand)
            return
        for item in sorted(node.children):
            self._gen(node.children[item], prefix + (item,), depth - 1, out)

    def _prune_ok(self, cand: Itemset) -> bool:
        for drop in range(len(cand) - 2):
            if not self.contains(cand[:drop] + cand[drop + 1 :]):
                return False
        return True
