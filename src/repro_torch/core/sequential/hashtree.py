"""Hash tree candidate store — Agrawal & Srikant [2], as implemented in §4.

Two node classes mirror the paper's Java design: ``InnerNode`` holds a
``child_max_size``-slot table routed by ``h(item) = item % child_max_size``;
``LeafNode`` holds a plain list of candidates that is linearly scanned (the
two-phase retrieval the paper blames for hash-tree slowness). Following §5.2,
``leaf_max_size`` may be ignored (``None``): a leaf at depth d < k still splits
once it receives more than one distinct routing item, but is never forced to by
a size threshold — we also support the classic size-triggered split for the
non-paper configuration.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.itemsets import Itemset


class LeafNode:
    __slots__ = ("candidates", "counts")

    def __init__(self) -> None:
        self.candidates: List[Itemset] = []
        self.counts: List[int] = []


class InnerNode:
    __slots__ = ("table",)

    def __init__(self, size: int) -> None:
        self.table: List[Optional[object]] = [None] * size


class HashTree:
    name = "hash_tree"

    def __init__(
        self,
        candidates: Sequence[Itemset] = (),
        child_max_size: int = 20,
        leaf_max_size: Optional[int] = None,
    ) -> None:
        self.child_max_size = child_max_size
        # Paper §5.2 "ignored the second parameter leaf_max_size": splitting is
        # then governed purely by depth (split while depth < k). A size-based
        # threshold is kept available for the classic configuration.
        self.leaf_max_size = leaf_max_size
        self.k = max((len(c) for c in candidates), default=0)
        self.root: object = LeafNode()
        for c in candidates:
            self.insert(c)

    def _h(self, item: int) -> int:
        return int(item) % self.child_max_size

    def insert(self, itemset: Itemset) -> None:
        itemset = tuple(int(x) for x in itemset)
        self.k = max(self.k, len(itemset))
        self.root = self._insert(self.root, itemset, 0)

    def _insert(self, node: object, itemset: Itemset, depth: int) -> object:
        if isinstance(node, InnerNode):
            slot = self._h(itemset[depth])
            child = node.table[slot]
            if child is None:
                child = LeafNode()
            node.table[slot] = self._insert(child, itemset, depth + 1)
            return node
        assert isinstance(node, LeafNode)
        node.candidates.append(itemset)
        node.counts.append(0)
        if self._should_split(node, depth, len(itemset)):
            inner: object = InnerNode(self.child_max_size)
            for cand in node.candidates:
                inner = self._insert(inner, cand, depth)  # recursive re-route
            return inner
        return node

    def _should_split(self, leaf: LeafNode, depth: int, k: int) -> bool:
        if depth >= k:
            return False  # cannot route deeper than the itemset length
        if self.leaf_max_size is None:
            return len(leaf.candidates) > 1
        return len(leaf.candidates) > self.leaf_max_size

    def contains(self, itemset: Itemset) -> bool:
        itemset = tuple(int(x) for x in itemset)
        node = self.root
        depth = 0
        while isinstance(node, InnerNode):
            node = node.table[self._h(itemset[depth])]
            depth += 1
            if node is None:
                return False
        assert isinstance(node, LeafNode)
        return itemset in node.candidates

    # -- support counting (Agrawal-Srikant subset()) -----------------------
    def count_transaction(self, transaction: Sequence[int]) -> None:
        t = sorted(set(int(x) for x in transaction))
        if len(t) >= self.k > 0:
            self._subset(self.root, t, 0, set())

    def _subset(self, node: object, t: List[int], start: int, seen: set) -> None:
        if node is None:
            return
        if isinstance(node, LeafNode):
            if id(node) in seen:
                return  # a leaf may be reached via several hash paths
            seen.add(id(node))
            tset = set(t)
            for i, cand in enumerate(node.candidates):
                ok = True
                for item in cand:
                    if item not in tset:
                        ok = False
                        break
                if ok:
                    node.counts[i] += 1
            return
        assert isinstance(node, InnerNode)
        # Hash every remaining item and recurse into the matching subtree.
        for i in range(start, len(t)):
            self._subset(node.table[self._h(t[i])], t, i + 1, seen)

    def counts(self) -> Dict[Itemset, int]:
        out: Dict[Itemset, int] = {}
        self._collect(self.root, out)
        return out

    def _collect(self, node: object, out: Dict[Itemset, int]) -> None:
        if node is None:
            return
        if isinstance(node, LeafNode):
            for cand, cnt in zip(node.candidates, node.counts):
                out[cand] = cnt
            return
        assert isinstance(node, InnerNode)
        for child in node.table:
            self._collect(child, out)
