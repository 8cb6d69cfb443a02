"""A B+-tree with range scans — the storage structure behind the semantic
index (paper §3.2: "a B-tree clustered on (video, label, time)").

Plain-Python, order-configurable, property-tested against a dict oracle in
tests/test_btree.py.  Keys are arbitrary comparable tuples; values accumulate
in insertion order (duplicate keys allowed — multiple boxes per key).
"""
from __future__ import annotations

import bisect
from typing import Any, Iterator, Optional


class _Node:
    __slots__ = ("keys", "children", "values", "next")

    def __init__(self, leaf: bool):
        self.keys: list = []
        self.children: Optional[list] = None if leaf else []
        self.values: Optional[list] = [] if leaf else None
        self.next: Optional[_Node] = None  # leaf chain for range scans

    @property
    def is_leaf(self) -> bool:
        return self.children is None


class BPlusTree:
    def __init__(self, order: int = 32):
        assert order >= 4
        self.order = order
        self.root = _Node(leaf=True)
        self._size = 0

    def __len__(self) -> int:
        return self._size

    # -- insert -------------------------------------------------------------
    def insert(self, key, value) -> None:
        self._size += 1
        split = self._insert(self.root, key, value)
        if split is not None:
            mid_key, right = split
            new_root = _Node(leaf=False)
            new_root.keys = [mid_key]
            new_root.children = [self.root, right]
            self.root = new_root

    def _insert(self, node: _Node, key, value):
        if node.is_leaf:
            i = bisect.bisect_right(node.keys, key)
            if i > 0 and node.keys[i - 1] == key:
                node.values[i - 1].append(value)
                self._size -= 0  # duplicate key: values accumulate
                return None
            node.keys.insert(i, key)
            node.values.insert(i, [value])
            if len(node.keys) > self.order:
                return self._split_leaf(node)
            return None
        i = bisect.bisect_right(node.keys, key)
        split = self._insert(node.children[i], key, value)
        if split is not None:
            mid_key, right = split
            node.keys.insert(i, mid_key)
            node.children.insert(i + 1, right)
            if len(node.keys) > self.order:
                return self._split_inner(node)
        return None

    def _split_leaf(self, node: _Node):
        mid = len(node.keys) // 2
        right = _Node(leaf=True)
        right.keys = node.keys[mid:]
        right.values = node.values[mid:]
        node.keys = node.keys[:mid]
        node.values = node.values[:mid]
        right.next = node.next
        node.next = right
        return right.keys[0], right

    def _split_inner(self, node: _Node):
        mid = len(node.keys) // 2
        right = _Node(leaf=False)
        mid_key = node.keys[mid]
        right.keys = node.keys[mid + 1:]
        right.children = node.children[mid + 1:]
        node.keys = node.keys[:mid]
        node.children = node.children[:mid + 1]
        return mid_key, right

    # -- lookup -------------------------------------------------------------
    def _leaf_for(self, key) -> _Node:
        node = self.root
        while not node.is_leaf:
            i = bisect.bisect_right(node.keys, key)
            node = node.children[i]
        return node

    def get(self, key) -> list:
        leaf = self._leaf_for(key)
        i = bisect.bisect_left(leaf.keys, key)
        if i < len(leaf.keys) and leaf.keys[i] == key:
            return list(leaf.values[i])
        return []

    def scan(self, lo, hi) -> Iterator[tuple[Any, list]]:
        """Yield (key, values) for lo <= key < hi, in key order."""
        leaf = self._leaf_for(lo)
        i = bisect.bisect_left(leaf.keys, lo)
        while leaf is not None:
            while i < len(leaf.keys):
                k = leaf.keys[i]
                if k >= hi:
                    return
                yield k, list(leaf.values[i])
                i += 1
            leaf = leaf.next
            i = 0

    def keys(self) -> Iterator:
        node = self.root
        while not node.is_leaf:
            node = node.children[0]
        while node is not None:
            yield from node.keys
            node = node.next

    def depth(self) -> int:
        d, node = 1, self.root
        while not node.is_leaf:
            node = node.children[0]
            d += 1
        return d
