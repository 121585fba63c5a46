"""Nested (2- and 3-level) SMTs sharing one node store.

Host copy of `plonky2_tpu/smt/layered.py` (the reference's
`smt/layered_tree.rs` and `layered_layered_tree.rs`).  `set` writes the
innermost tree first and then carries each inner root up as its parent's
value; `find` chains inclusion proofs downward;
`verify_layered_smt_connection` checks, for each role of the upper
process proof, that the lower tree's roots match the upper tree's values
and raises ValueError where they do not.
"""

from __future__ import annotations

from .hash_out import HashOut, ZERO_HASH
from .proof import ProcessMerkleProofRole, _require
from .tree import SparseMerkleTree


class LayeredSparseMerkleTree(SparseMerkleTree):
    """2-level SMT: a value at (key1, key2); a zero value deletes it."""

    def set(self, key1: HashOut, key2: HashOut, value: HashOut):
        layer1_root = self.get_root()
        layer2_root = self._get_at(layer1_root, key1)
        result2, layer2_root = self._process(layer2_root, key2, value)
        result1, layer1_root = self._process(layer1_root, key1, layer2_root)
        self.roots_db.set(layer1_root)
        return result1, result2

    def find(self, key1: HashOut, key2: HashOut):
        result1 = self._find(self.get_root(), key1)
        layer2_root = result1.value if result1.found else ZERO_HASH
        result2 = self._find(layer2_root, key2)
        return result1, result2

    # -- shared by the 3-level tree ------------------------------------------

    def _get_at(self, root: HashOut, key: HashOut) -> HashOut:
        res = self._find(root, key)
        return res.value if res.found else ZERO_HASH

    def _process(self, root: HashOut, key: HashOut, value: HashOut):
        """The process proof of setting key to value under an explicit
        root: update / insert / remove / no-op, as `SparseMerkleTree.set`
        chooses -> (proof, new root)."""
        res = self._find(root, key)
        if value == ZERO_HASH:
            if res.found:
                return self._remove(root, key)
            return self._noop(root, key)
        if res.found:
            return self._update(root, key, value)
        return self._insert(root, key, value)


class LayeredLayeredSparseMerkleTree(LayeredSparseMerkleTree):
    """3-level SMT: a value at (key1, key2, key3)."""

    def set(self, key1: HashOut, key2: HashOut, key3: HashOut,
            value: HashOut):
        layer1_root = self.get_root()
        layer2_root = self._get_at(layer1_root, key1)
        layer3_root = self._get_at(layer2_root, key2)
        result3, layer3_root = self._process(layer3_root, key3, value)
        result2, layer2_root = self._process(layer2_root, key2, layer3_root)
        result1, layer1_root = self._process(layer1_root, key1, layer2_root)
        self.roots_db.set(layer1_root)
        return result1, result2, result3

    def find(self, key1: HashOut, key2: HashOut, key3: HashOut):
        result1 = self._find(self.get_root(), key1)
        layer2_root = result1.value if result1.found else ZERO_HASH
        result2 = self._find(layer2_root, key2)
        layer3_root = result2.value if result2.found else ZERO_HASH
        result3 = self._find(layer3_root, key3)
        return result1, result2, result3


def verify_layered_smt_connection(upper_fnc: ProcessMerkleProofRole,
                                  old_upper_value: HashOut,
                                  new_upper_value: HashOut,
                                  old_lower_root: HashOut,
                                  new_lower_root: HashOut) -> None:
    """Raise ValueError if the lower tree's roots do not match the upper
    tree's values for the upper proof's role."""
    R = ProcessMerkleProofRole
    if upper_fnc == R.Update:
        _require(old_lower_root == old_upper_value, "update: old root/value")
        _require(new_lower_root == new_upper_value, "update: new root/value")
    elif upper_fnc == R.Insert:
        _require(old_lower_root == ZERO_HASH, "insert: old root must be zero")
        _require(new_lower_root == new_upper_value, "insert: new root/value")
    elif upper_fnc == R.Delete:
        _require(old_lower_root == old_upper_value, "delete: old root/value")
        _require(new_lower_root == ZERO_HASH, "delete: new root must be zero")
    else:  # NoOp
        _require(old_lower_root == ZERO_HASH, "noop: old root must be zero")
        _require(new_lower_root == ZERO_HASH, "noop: new root must be zero")
