"""MA (meta-adaptive) decision trees for modular decoding.

Capability reference: jxl/src/frame/modular/tree.rs. A tree is stored as
flat arrays (property/splitval/left-right child per inner node; predictor/
offset/multiplier/context per leaf) — the same layout the specialized and
device decoders consume.
"""

from __future__ import annotations

from ..errors import InvalidBitstream, InvalidPredictor, InvalidProperty, TreeMultiplierTooLarge, TreeSplitOnEmptyRange, TreeTooLarge, TreeTooTall
from ..entropy import Histograms, SymbolReader
from ..io.bit_reader import BitReader
from .predict import NUM_PREDICTORS, Predictor

NUM_NONREF_PROPERTIES = 16
PROPERTIES_PER_PREVCHAN = 4

_SPLIT_VAL_CTX = 0
_PROPERTY_CTX = 1
_PREDICTOR_CTX = 2
_OFFSET_CTX = 3
_MULTIPLIER_LOG_CTX = 4
_MULTIPLIER_BITS_CTX = 5
_NUM_TREE_CONTEXTS = 6


class TreeNode:
    """Split node (property >= 0) or leaf (property == -1)."""

    __slots__ = ("property", "splitval", "left", "right", "predictor", "offset", "multiplier", "context")

    def __init__(self):
        self.property = -1
        self.splitval = 0
        self.left = 0
        self.right = 0
        self.predictor = Predictor.ZERO
        self.offset = 0
        self.multiplier = 1
        self.context = 0

    @property
    def is_leaf(self) -> bool:
        return self.property < 0

    def __repr__(self):
        if self.is_leaf:
            return f"Leaf(pred={self.predictor.name}, off={self.offset}, mul={self.multiplier}, ctx={self.context})"
        return f"Split(p{self.property} > {self.splitval} ? {self.left} : {self.right})"


class Tree:
    __slots__ = ("_nodes", "histograms", "num_properties", "_native_packed", "_arr")

    @property
    def nodes(self) -> list:
        """TreeNode objects, built lazily from the packed array (the
        native decode paths consume the array directly; only the python
        oracle and analysis helpers need objects)."""
        if self._nodes is None:
            nodes = []
            for row in self._arr.tolist():
                node = TreeNode()
                if row[0] >= 0:
                    node.property = row[0]
                    node.splitval = row[1]
                    node.left = row[2]
                    node.right = row[3]
                else:
                    node.predictor = Predictor(row[4])
                    node.offset = row[5]
                    node.multiplier = row[6]
                    node.context = row[7]
                nodes.append(node)
            self._nodes = nodes
        return self._nodes

    def __len__(self) -> int:
        return len(self._arr) if self._arr is not None else len(self._nodes)

    @staticmethod
    def read(br: BitReader, size_limit: int) -> "Tree":
        tree_histograms = Histograms.decode(_NUM_TREE_CONTEXTS, br, allow_lz77=True)

        from .. import native

        if native.available():
            res = native.decode_tree_native(tree_histograms, br, size_limit)
            if res is not None:
                arr, max_property = res
                import numpy as np

                t = Tree.__new__(Tree)
                t._arr = np.ascontiguousarray(arr)
                t._nodes = None
                t._native_packed = t._arr
                t.num_properties = max_property + 1
                t._validate_arr(arr)
                t.histograms = Histograms.decode(
                    (len(arr) + 1) // 2, br, allow_lz77=True
                )
                return t

        reader = SymbolReader(tree_histograms, br)
        nodes: list[TreeNode] = []
        to_decode = 1
        leaf_id = 0
        max_property = 0
        while to_decode > 0:
            if len(nodes) > size_limit:
                raise TreeTooLarge(f"MA tree too large (> {size_limit})")
            to_decode -= 1
            prop_plus1 = reader.read_unsigned(tree_histograms, br, _PROPERTY_CTX)
            node = TreeNode()
            if prop_plus1 > 0:
                prop = prop_plus1 - 1
                if prop > 255:
                    raise InvalidProperty(f"invalid property {prop}")
                max_property = max(max_property, prop)
                node.property = prop
                node.splitval = reader.read_signed(tree_histograms, br, _SPLIT_VAL_CTX)
                node.left = len(nodes) + to_decode + 1
                node.right = node.left + 1
                to_decode += 2
            else:
                pred = reader.read_unsigned(tree_histograms, br, _PREDICTOR_CTX)
                if pred >= NUM_PREDICTORS:
                    raise InvalidPredictor(f"invalid predictor {pred}")
                node.predictor = Predictor(pred)
                node.offset = reader.read_signed(tree_histograms, br, _OFFSET_CTX)
                mul_log = reader.read_unsigned(tree_histograms, br, _MULTIPLIER_LOG_CTX)
                if mul_log >= 31:
                    raise TreeMultiplierTooLarge("tree multiplier too large")
                mul_bits = reader.read_unsigned(tree_histograms, br, _MULTIPLIER_BITS_CTX)
                multiplier = (mul_bits + 1) << mul_log
                if multiplier > 0xFFFFFFFF:
                    raise TreeMultiplierTooLarge("tree multiplier bits too large")
                node.multiplier = multiplier
                node.context = leaf_id
                leaf_id += 1
            nodes.append(node)
        reader.check_final_state(tree_histograms, br)

        t = Tree.__new__(Tree)
        t._nodes = nodes
        t._arr = None
        t.num_properties = max_property + 1
        t._validate()
        t.histograms = Histograms.decode((len(nodes) + 1) // 2, br, allow_lz77=True)
        return t

    def _validate(self, height_limit: int = 2048):
        """DFS validation: splits must be on non-empty property ranges and
        the height must stay under the limit (ref tree.rs:40-156)."""
        nodes = self.nodes
        if not nodes:
            return
        INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
        ranges = {}  # property -> (lo, hi) along current path

        def visit(idx: int, depth: int):
            if depth > height_limit:
                raise TreeTooTall("MA tree too tall")
            node = nodes[idx]
            if node.is_leaf:
                return
            p = node.property
            lo, hi = ranges.get(p, (INT_MIN, INT_MAX))
            if lo > node.splitval or hi <= node.splitval:
                raise TreeSplitOnEmptyRange("MA tree split on empty range")
            ranges[p] = (node.splitval + 1, hi)
            visit(node.left, depth + 1)
            ranges[p] = (lo, node.splitval)
            visit(node.right, depth + 1)
            ranges[p] = (lo, hi)

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, height_limit * 3 + 100))
        try:
            visit(0, 0)
        finally:
            sys.setrecursionlimit(old_limit)

    def _validate_arr(self, a, height_limit: int = 2048):
        """Array-backed twin of _validate (no TreeNode construction)."""
        rows = a.tolist()
        if not rows:
            return
        INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
        ranges = {}

        def visit(idx: int, depth: int):
            if depth > height_limit:
                raise TreeTooTall("MA tree too tall")
            row = rows[idx]
            if row[0] < 0:
                return
            p, sv = row[0], row[1]
            lo, hi = ranges.get(p, (INT_MIN, INT_MAX))
            if lo > sv or hi <= sv:
                raise TreeSplitOnEmptyRange("MA tree split on empty range")
            ranges[p] = (sv + 1, hi)
            visit(row[2], depth + 1)
            ranges[p] = (lo, sv)
            visit(row[3], depth + 1)
            ranges[p] = (lo, hi)

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, height_limit * 3 + 100))
        try:
            visit(0, 0)
        finally:
            sys.setrecursionlimit(old_limit)

    def walk(self, props) -> TreeNode:
        nodes = self.nodes
        node = nodes[0]
        while node.property >= 0:
            node = nodes[node.left if props[node.property] > node.splitval else node.right]
        return node

    # -- analysis used to pick decode specializations ----------------------

    @property
    def uses_weighted(self) -> bool:
        if self._arr is not None:
            a = self._arr
            leaf = a[:, 0] < 0
            return bool((a[leaf, 4] == 6).any() or (a[~leaf, 0] == 15).any())
        return any(
            (n.is_leaf and n.predictor == Predictor.WEIGHTED) or n.property == 15
            for n in self.nodes
        )

    @property
    def max_property_used(self) -> int:
        return self.num_properties - 1

    @property
    def is_channel_static(self) -> bool:
        """Channel-split tree whose leaves are static simple predictors
        (Zero/West/North/Gradient, offset 0, multiplier 1) — every such
        stream's residuals can be emitted raw (native residual mode) and
        reconstructed by a device lane: identity (Zero), row/col cumsum
        (West/North, int32-wrap exact), or the gradient wavefront.
        Mirrors the native chan_static analysis (modular_decode.cc)."""
        if self._arr is not None:
            a = self._arr
            leaf = a[:, 0] < 0
            p = a[leaf, 4]
            return bool(
                (a[~leaf, 0] == 0).all()
                and ((p == 0) | (p == 1) | (p == 2) | (p == 5)).all()
                and (a[leaf, 5] == 0).all()
                and (a[leaf, 6] == 1).all()
            )
        return all(
            (not n.is_leaf and n.property == 0)
            or (
                n.is_leaf
                and int(n.predictor) in (0, 1, 2, 5)
                and n.offset == 0
                and n.multiplier == 1
            )
            for n in self.nodes
        )

    def leaf_predictor_for_channel(self, chan: int) -> int:
        """Leaf predictor reached by a channel-split walk (property 0 ==
        channel index). Only meaningful when is_channel_static."""
        if self._arr is not None:
            a = self._arr
            i = 0
            while a[i, 0] >= 0:
                i = a[i, 2] if chan > a[i, 1] else a[i, 3]
            return int(a[i, 4])
        node = self.nodes[0]
        while not node.is_leaf:
            node = self.nodes[node.left if chan > node.splitval else node.right]
        return int(node.predictor)

    @property
    def is_gradient_only(self) -> bool:
        """Channel-split + gradient leaves only — the fast-lossless shape."""
        if self._arr is not None:
            a = self._arr
            leaf = a[:, 0] < 0
            return bool(
                (a[~leaf, 0] == 0).all()
                and (
                    (a[leaf, 4] == 5) & (a[leaf, 5] == 0) & (a[leaf, 6] == 1)
                ).all()
            )
        return all(
            (not n.is_leaf and n.property == 0)
            or (
                n.is_leaf
                and n.predictor == Predictor.GRADIENT
                and n.offset == 0
                and n.multiplier == 1
            )
            for n in self.nodes
        )
