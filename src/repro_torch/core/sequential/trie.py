"""Linear-search trie (prefix tree) candidate store — Bodon & Rónyai [5].

Each node keeps its children as a list of (item, child) pairs ordered by item,
and moving one level down requires a linear scan of that list — exactly the
behaviour the paper attributes to the plain trie (§2.3: "There is a need to make
a linear search at each node to move downward").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.itemsets import Itemset


class TrieNode:
    __slots__ = ("items", "children", "count", "terminal")

    def __init__(self) -> None:
        self.items: List[int] = []  # link labels, kept sorted
        self.children: List["TrieNode"] = []
        self.count = 0
        self.terminal = False  # node closes a stored itemset

    def find(self, item: int) -> Optional["TrieNode"]:
        # Deliberate linear search: this is the trie's per-level cost model.
        for i, lbl in enumerate(self.items):
            if lbl == item:
                return self.children[i]
            if lbl > item:
                return None
        return None

    def child(self, item: int) -> "TrieNode":
        for i, lbl in enumerate(self.items):
            if lbl == item:
                return self.children[i]
            if lbl > item:
                node = TrieNode()
                self.items.insert(i, item)
                self.children.insert(i, node)
                return node
        node = TrieNode()
        self.items.append(item)
        self.children.append(node)
        return node


class Trie:
    """Candidate store with trie-native candidate generation and counting."""

    name = "trie"

    def __init__(self, candidates: Sequence[Itemset] = ()) -> None:
        self.root = TrieNode()
        self.k = 0
        for c in candidates:
            self.insert(c)

    def insert(self, itemset: Itemset) -> None:
        node = self.root
        for item in itemset:
            node = node.child(int(item))
        node.terminal = True
        node.count = 0
        self.k = max(self.k, len(itemset))

    def contains(self, itemset: Itemset) -> bool:
        node = self.root
        for item in itemset:
            node = node.find(int(item))
            if node is None:
                return False
        return node.terminal

    # -- support counting -------------------------------------------------
    def count_transaction(self, transaction: Sequence[int]) -> None:
        t = sorted(set(int(x) for x in transaction))
        self._descend(self.root, t, 0, self.k)

    def _descend(self, node: TrieNode, t: List[int], start: int, remaining: int) -> None:
        if node.terminal and remaining == 0:
            node.count += 1
            return
        if remaining <= 0:
            return
        # Try every remaining transaction item as the next link, leaving room
        # for the (remaining - 1) further items.
        for i in range(start, len(t) - remaining + 1):
            child = node.find(t[i])
            if child is not None:
                self._descend(child, t, i + 1, remaining - 1)

    def counts(self) -> Dict[Itemset, int]:
        out: Dict[Itemset, int] = {}
        self._collect(self.root, (), out)
        return out

    def _collect(self, node: TrieNode, prefix: Itemset, out: Dict[Itemset, int]) -> None:
        if node.terminal:
            out[prefix] = node.count
        for item, child in zip(node.items, node.children):
            self._collect(child, prefix + (item,), out)

    # -- trie-native candidate generation (paper §2.2) ---------------------
    def generate_candidates(self) -> List[Itemset]:
        """Join children of each depth-(k-1) node pairwise; prune via lookup."""
        out: List[Itemset] = []
        self._gen(self.root, (), self.k - 1, out)
        return out

    def _gen(self, node: TrieNode, prefix: Itemset, depth: int, out: List[Itemset]) -> None:
        if depth == 0:
            labels = node.items
            for a in range(len(labels)):
                for b in range(a + 1, len(labels)):
                    cand = prefix + (labels[a], labels[b])
                    if self._prune_ok(cand):
                        out.append(cand)
            return
        for item, child in zip(node.items, node.children):
            self._gen(child, prefix + (item,), depth - 1, out)

    def _prune_ok(self, cand: Itemset) -> bool:
        for drop in range(len(cand) - 2):
            if not self.contains(cand[:drop] + cand[drop + 1 :]):
                return False
        return True
