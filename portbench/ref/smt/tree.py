"""Path-compressed sparse Merkle tree (circomlib-style) over Poseidon.

Host copy of `plonky2_tpu/smt/tree.py` (the reference's `smt/tree.rs` and
`smt/goldilocks_poseidon/mod.rs`).  Keys, values and node ids are `HashOut`
tuples of 4 Goldilocks ints.  The tree is host witness machinery: it
produces the process proofs whose circuits (`gadgets/smt.py`) the prover
proves on the device.
"""

from __future__ import annotations

from ..hashes import poseidon
from .hash_out import HashOut, ZERO_HASH, key_to_bits
from .proof import (ProcessMerkleProofRole, SparseMerkleInclusionProof,
                    SparseMerkleProcessProof)

# Node = ("leaf", key, value) | ("internal", left, right)


class PoseidonNodeHash:
    """internal = two_to_one(l, r); leaf = hash_pad([k.., v.., 1])."""

    @staticmethod
    def internal(left: HashOut, right: HashOut) -> HashOut:
        return tuple(poseidon.two_to_one_s(list(left), list(right)))

    @staticmethod
    def leaf(key: HashOut, value: HashOut) -> HashOut:
        return tuple(poseidon.hash_pad_s(list(key) + list(value) + [1]))

    @classmethod
    def node(cls, node) -> HashOut:
        if node[0] == "leaf":
            return cls.leaf(node[1], node[2])
        return cls.internal(node[1], node[2])


class NodeDataMemory:
    """In-memory node store; deletes are no-ops so that historical roots
    stay resolvable."""

    def __init__(self):
        self.nodes: dict = {}

    def get(self, key: HashOut):
        return self.nodes.get(key)

    def multi_get(self, keys):
        return [self.nodes.get(k) for k in keys]

    def multi_insert(self, entries):
        for k, v in entries:
            self.nodes[k] = v

    def multi_delete(self, keys):
        pass  # history-preserving


class RootDataMemory:
    """Root history: set() appends, get() returns the latest."""

    def __init__(self):
        self.roots: list[HashOut] = [ZERO_HASH]

    def get(self) -> HashOut:
        return self.roots[-1]

    def set(self, root: HashOut) -> None:
        self.roots.append(root)


class RootDataTmp:
    """Single-slot root store (the reference's smt/mod.rs:135-156)."""

    def __init__(self, root: HashOut = ZERO_HASH):
        self.root = root

    def get(self) -> HashOut:
        return self.root

    def set(self, root: HashOut) -> None:
        self.root = root


class SparseMerkleTree:
    def __init__(self, nodes_db=None, roots_db=None, hasher=PoseidonNodeHash):
        self.nodes_db = nodes_db if nodes_db is not None else NodeDataMemory()
        self.roots_db = roots_db if roots_db is not None else RootDataMemory()
        self.hasher = hasher

    # -- public API --------------------------------------------------------

    def get_root(self) -> HashOut:
        return self.roots_db.get()

    def change_root(self, root: HashOut) -> None:
        if root != ZERO_HASH and self.nodes_db.get(root) is None:
            raise KeyError("the node corresponding `root_hash` does not exist")
        self.roots_db.set(root)

    def update(self, key: HashOut, new_value: HashOut) -> SparseMerkleProcessProof:
        return self._with_root(self._update, key, new_value)

    def insert(self, key: HashOut, value: HashOut) -> SparseMerkleProcessProof:
        return self._with_root(self._insert, key, value)

    def remove(self, key: HashOut) -> SparseMerkleProcessProof:
        return self._with_root(self._remove, key)

    def set(self, key: HashOut, value: HashOut) -> SparseMerkleProcessProof:
        """update / insert / remove / no-op, chosen by the key's presence and
        whether the value is zero."""
        res = self._find(self.roots_db.get(), key)
        if value == ZERO_HASH:
            op = self._remove if res.found else self._noop
            args = (key,)
        else:
            op = self._update if res.found else self._insert
            args = (key, value)
        return self._with_root(op, *args)

    def find(self, key: HashOut) -> SparseMerkleInclusionProof:
        return self._find(self.roots_db.get(), key)

    def get(self, key: HashOut) -> HashOut:
        res = self.find(key)
        return res.value if res.found else ZERO_HASH

    # -- internals ---------------------------------------------------------

    def _with_root(self, op, *args):
        root = self.roots_db.get()
        proof, new_root = op(root, *args)
        self.roots_db.set(new_root)
        return proof

    def _find(self, root: HashOut, key: HashOut) -> SparseMerkleInclusionProof:
        """Iterative descent collecting siblings."""
        key_bits = key_to_bits(key)
        siblings: list[HashOut] = []
        node_id, level = root, 0
        while True:
            if node_id == ZERO_HASH:
                return SparseMerkleInclusionProof(
                    root=root, found=False, key=key, value=ZERO_HASH,
                    not_found_key=ZERO_HASH, not_found_value=ZERO_HASH,
                    siblings=siblings, is_old0=True)
            node = self.nodes_db.get(node_id)
            if node is None:
                raise KeyError("searching node is not found")
            if node[0] == "leaf":
                rk, rv = node[1], node[2]
                if rk == key:
                    return SparseMerkleInclusionProof(
                        root=root, found=True, key=key, value=rv,
                        not_found_key=ZERO_HASH, not_found_value=ZERO_HASH,
                        siblings=siblings, is_old0=False)
                return SparseMerkleInclusionProof(
                    root=root, found=False, key=key, value=ZERO_HASH,
                    not_found_key=rk, not_found_value=rv,
                    siblings=siblings, is_old0=False)
            left, right = node[1], node[2]
            if key_bits[level]:
                siblings.append(left)
                node_id = right
            else:
                siblings.append(right)
                node_id = left
            level += 1

    def _update(self, root, key, new_value):
        res = self._find(root, key)
        if not res.found:
            raise KeyError("given key does not exists")
        if new_value == ZERO_HASH:
            raise ValueError("value must be non-zero")
        found_key, found_value = res.key, res.value

        H = self.hasher
        inserts, deletes = [], []
        rt_old = H.leaf(found_key, found_value)
        rt_new = H.leaf(found_key, new_value)
        inserts.append((rt_new, ("leaf", found_key, new_value)))
        deletes.append(rt_old)

        key_bits = key_to_bits(found_key)
        for sibling, bit in reversed(list(zip(res.siblings, key_bits))):
            if bit:
                old_node = ("internal", sibling, rt_old)
                new_node = ("internal", sibling, rt_new)
            else:
                old_node = ("internal", rt_old, sibling)
                new_node = ("internal", rt_new, sibling)
            rt_old = H.node(old_node)
            rt_new = H.node(new_node)
            deletes.append(rt_old)
            inserts.append((rt_new, new_node))

        self.nodes_db.multi_delete(deletes)
        self.nodes_db.multi_insert(inserts)
        proof = SparseMerkleProcessProof(
            old_root=res.root, old_key=found_key, old_value=found_value,
            new_root=rt_new, new_key=found_key, new_value=new_value,
            siblings=res.siblings, is_old0=False,
            fnc=ProcessMerkleProofRole.Update)
        return proof, rt_new

    def _insert(self, root, key, value):
        res = self._find(root, key)
        if res.found:
            raise KeyError("given key already exists")
        if value == ZERO_HASH:
            raise ValueError("value must be non-zero")

        H = self.hasher
        siblings = list(res.siblings)
        nf_key, nf_value = res.not_found_key, res.not_found_value

        if not res.is_old0:
            # collided with an existing leaf: extend the path until the keys
            # diverge, then push the old leaf hash as the deepest sibling
            old_bits, new_bits = key_to_bits(nf_key), key_to_bits(key)
            for ob, nb in list(zip(old_bits, new_bits))[len(siblings):]:
                if ob != nb:
                    break
                siblings.append(ZERO_HASH)
            rt_old = H.leaf(nf_key, nf_value)
            siblings.append(rt_old)
            added_one, mixed = True, False
        else:
            mixed = len(siblings) > 0
            added_one, rt_old = False, ZERO_HASH

        inserts, deletes = [], []
        rt = H.leaf(key, value)
        inserts.append((rt, ("leaf", key, value)))

        new_bits = key_to_bits(key)
        for level, (sibling, bit) in enumerate(
                reversed(list(zip(siblings, new_bits)))):
            if level != 0 and sibling != ZERO_HASH:
                mixed = True
            if mixed:
                old_node = ("internal", sibling, rt_old) if bit \
                    else ("internal", rt_old, sibling)
                rt_old = H.node(old_node)
                deletes.append(rt_old)
            new_node = ("internal", sibling, rt) if bit \
                else ("internal", rt, sibling)
            rt = H.node(new_node)
            inserts.append((rt, new_node))

        if added_one:
            siblings.pop()
        while siblings and siblings[-1] == ZERO_HASH:
            siblings.pop()

        self.nodes_db.multi_delete(deletes)
        self.nodes_db.multi_insert(inserts)
        proof = SparseMerkleProcessProof(
            old_root=res.root, old_key=nf_key, old_value=nf_value,
            new_root=rt, new_key=key, new_value=value,
            siblings=siblings, is_old0=res.is_old0,
            fnc=ProcessMerkleProofRole.Insert)
        return proof, rt

    def _remove(self, root, key):
        """Old and new are swapped against circomlib, so that a chain of
        proofs runs in the order of the transitions."""
        res = self._find(root, key)
        if not res.found:
            raise KeyError("given key does not exists")
        found_key, found_value = res.key, res.value

        H = self.hasher
        deletes, inserts = [], []
        rt_old = H.leaf(found_key, found_value)
        deletes.append(rt_old)

        if res.siblings:
            last_sibling = res.siblings[-1]
            next_node = self.nodes_db.get(last_sibling)
            if next_node is None:
                raise KeyError("sibling node missing")
            if next_node[0] == "leaf":
                mixed = False
                res_old_key, res_old_value = next_node[1], next_node[2]
                res_is_old0, rt_new = False, last_sibling
            else:
                mixed = True
                res_old_key, res_old_value = found_key, ZERO_HASH
                res_is_old0, rt_new = True, ZERO_HASH
        else:
            mixed = False
            res_old_key, res_old_value = found_key, ZERO_HASH
            res_is_old0, rt_new = True, ZERO_HASH

        key_bits = key_to_bits(found_key)
        res_siblings: list[HashOut] = []
        for level, (sibling, bit) in enumerate(
                reversed(list(zip(res.siblings, key_bits)))):
            new_sibling = ZERO_HASH if (level == 0 and not res_is_old0) \
                else sibling
            old_node = ("internal", sibling, rt_old) if bit \
                else ("internal", rt_old, sibling)
            rt_old = H.node(old_node)
            deletes.append(rt_old)
            if new_sibling != ZERO_HASH:
                mixed = True
            if mixed:
                res_siblings.insert(0, sibling)
                new_node = ("internal", new_sibling, rt_new) if bit \
                    else ("internal", rt_new, new_sibling)
                rt_new = H.node(new_node)
                inserts.append((rt_new, new_node))

        self.nodes_db.multi_delete(deletes)
        self.nodes_db.multi_insert(inserts)
        proof = SparseMerkleProcessProof(
            old_root=rt_old, old_key=found_key, old_value=found_value,
            new_root=rt_new, new_key=res_old_key, new_value=res_old_value,
            siblings=res_siblings, is_old0=res_is_old0,
            fnc=ProcessMerkleProofRole.Delete)
        return proof, rt_new

    def _noop(self, root, key):
        proof = SparseMerkleProcessProof(
            old_root=root, old_key=key, old_value=ZERO_HASH,
            new_root=root, new_key=key, new_value=ZERO_HASH,
            siblings=[], is_old0=True, fnc=ProcessMerkleProofRole.NoOp)
        return proof, root
