"""SMT proof records and their native verifiers (the circomlib SMT state
machines).

Host copy of `plonky2_tpu/smt/proof.py` (the reference's
`smt/proof/{inclusion,process,common}.rs`).  The verifiers raise
ValueError on a proof that does not hold.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .hash_out import HashOut, ZERO_HASH, key_to_bits


class ProcessMerkleProofRole(Enum):
    NoOp = (False, False)
    Update = (False, True)
    Insert = (True, False)
    Delete = (True, True)

    @property
    def bits(self):
        return self.value


@dataclass
class SparseMerkleInclusionProof:
    root: HashOut
    found: bool
    key: HashOut
    value: HashOut
    not_found_key: HashOut
    not_found_value: HashOut
    siblings: list
    is_old0: bool


@dataclass
class SparseMerkleProcessProof:
    old_root: HashOut
    old_key: HashOut
    old_value: HashOut
    new_root: HashOut
    new_key: HashOut
    new_value: HashOut
    siblings: list
    is_old0: bool
    fnc: ProcessMerkleProofRole


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def smt_lev_ins(siblings: list, enabled: bool) -> list[bool]:
    """levIns[i]: the insertion happens at level i."""
    is_zeros = [s == ZERO_HASH for s in siblings]
    if enabled:
        _require(is_zeros[-1], "last level must have a zero sibling")
    is_zeros = list(reversed(is_zeros)) + [False]
    lev_ins = []
    last_done = False
    for i in range(len(siblings)):
        lev_ins.append(not is_zeros[i + 1] and not last_done)
        last_done = last_done or not is_zeros[i + 1]
    lev_ins.reverse()
    return lev_ins


class St(Enum):
    Top = 0
    Bottom = 1
    OldIsZero = 2
    NewOne = 3
    Update = 4
    Na = 5


def smt_processor_sm(prev: St, is_different_bit: bool, is_old0: bool,
                     is_inserting_level: bool, is_insert_op: bool) -> St:
    """One transition of circomlib's smtprocessorsm."""
    if prev == St.Top:
        if not is_inserting_level:
            return St.Top
        if not is_insert_op:
            return St.Update
        if is_old0:
            return St.OldIsZero
        if is_different_bit:
            return St.NewOne
        return St.Bottom
    if prev == St.Bottom:
        return St.NewOne if is_different_bit else St.Bottom
    return St.Na


def calc_old_new_root(hasher, old_kv, new_kv, siblings, n2b_new, sm,
                      num_levels) -> tuple:
    """Per-level reconstruction of the old and the new root."""
    old1_leaf = hasher.leaf(*old_kv)
    new1_leaf = hasher.leaf(*new_kv)
    prev = (ZERO_HASH, ZERO_HASH)
    for i in range(num_levels - 1, -1, -1):
        bit = n2b_new[i]
        old_child, new_child = prev
        old_hash = hasher.internal(siblings[i], old_child) if bit \
            else hasher.internal(old_child, siblings[i])
        st = sm[i]
        old_root = {St.Top: old_hash, St.Bottom: old1_leaf,
                    St.NewOne: old1_leaf, St.Update: old1_leaf}.get(st, ZERO_HASH)
        new_left = {St.Top: new_child, St.Bottom: new_child,
                    St.NewOne: new1_leaf}.get(st, ZERO_HASH)
        new_right = {St.Top: siblings[i], St.NewOne: old1_leaf}.get(st, ZERO_HASH)
        new_hash = hasher.internal(new_right, new_left) if bit \
            else hasher.internal(new_left, new_right)
        new_root = {St.Top: new_hash, St.Bottom: new_hash, St.NewOne: new_hash,
                    St.OldIsZero: new1_leaf, St.Update: new1_leaf}.get(st, ZERO_HASH)
        prev = (old_root, new_root)
    return prev


def verify_smt_process_proof(hasher, proof: SparseMerkleProcessProof,
                             num_levels: int = 256) -> None:
    """Raises ValueError if the process proof does not hold."""
    enabled = proof.fnc != ProcessMerkleProofRole.NoOp

    if proof.fnc == ProcessMerkleProofRole.Delete:
        # delete = insert with old/new flipped
        fnc = ProcessMerkleProofRole.Insert
        old_key, old_value, old_root = proof.new_key, proof.new_value, proof.new_root
        new_key, new_value, new_root = proof.old_key, proof.old_value, proof.old_root
    else:
        fnc = proof.fnc
        old_key, old_value, old_root = proof.old_key, proof.old_value, proof.old_root
        new_key, new_value, new_root = proof.new_key, proof.new_value, proof.new_root

    n2b_old = key_to_bits(old_key, num_levels)
    n2b_new = key_to_bits(new_key, num_levels)
    siblings = list(proof.siblings)
    _require(len(siblings) < num_levels, "too many siblings")
    siblings += [ZERO_HASH] * (num_levels - len(siblings))
    lev_ins = smt_lev_ins(siblings, enabled)

    prev = St.Top if enabled else St.Na
    is_insert_op = fnc == ProcessMerkleProofRole.Insert
    sm = []
    for i in range(num_levels):
        st = smt_processor_sm(prev, n2b_old[i] != n2b_new[i], proof.is_old0,
                              lev_ins[i], is_insert_op)
        sm.append(st)
        prev = st
    _require(sm[-1] not in (St.Top, St.Bottom), "state machine must terminate")

    roots = calc_old_new_root(hasher, (old_key, old_value),
                              (new_key, new_value), siblings, n2b_new, sm,
                              num_levels)
    if enabled:
        _require(roots[0] == old_root, "old root mismatch")
        _require(roots[1] == new_root, "new root mismatch")
    else:
        _require(proof.old_root == proof.new_root, "no-op changes the root")
        _require(proof.old_value == proof.new_value, "no-op changes the value")
    if fnc == ProcessMerkleProofRole.Update or not enabled:
        _require(old_key == new_key, "update or no-op changes the key")


def verify_smt_inclusion_proof(hasher, proof: SparseMerkleInclusionProof,
                               num_levels: int = 256) -> None:
    """Native (non-)inclusion check, mirroring the circuit's verifier state
    machine.  Raises ValueError if the proof does not hold."""
    if not proof.found and not proof.is_old0:
        _require(proof.not_found_key != proof.key,
                 "non-inclusion must show a different leaf")
    leaf = hasher.leaf(proof.key, proof.value) if proof.found else (
        ZERO_HASH if proof.is_old0
        else hasher.leaf(proof.not_found_key, proof.not_found_value))
    bits = key_to_bits(proof.key, num_levels)
    root = leaf
    for i in range(len(proof.siblings) - 1, -1, -1):
        sib = proof.siblings[i]
        root = hasher.internal(sib, root) if bits[i] else hasher.internal(root, sib)
    _require(root == proof.root, "root mismatch")
