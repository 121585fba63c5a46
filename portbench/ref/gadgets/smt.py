"""In-circuit SMT verification: commons, inclusion proofs, process proofs.

Host copy of `plonky2_tpu/gadgets/smt.py` (the reference's
`smt/gadgets/`: `common.rs` leaf/internal hashes, conditional
reverse/select, hash arithmetic, boolean algebra and the in-circuit
`smt_lev_ins`; `verify/verify_smt.rs` inclusion proofs and their verifier
state machine; `process/process_smt.rs` process proofs, the circomlib
SMTProcessor state machine with delete as a reversed insert and the dual
old/new root reconstruction; `process/utils.rs` the role decode and
`verify_smt_transition`).

A hash target here is a plain list of 4 targets.
"""

from __future__ import annotations

from ..field import gl
from ..ir.builder import CircuitBuilder
from ..smt.hash_out import key_to_bits

HASH_ELEMS = 4


# ------------------------------------------------------------------
# commons (common.rs)
# ------------------------------------------------------------------

def zero_hash_t(b: CircuitBuilder):
    z = b.zero()
    return [z, z, z, z]


def add_virtual_hash(b: CircuitBuilder):
    return b.add_virtual_targets(HASH_ELEMS)


def add_virtual_hashes(b: CircuitBuilder, n: int):
    return [add_virtual_hash(b) for _ in range(n)]


def add_virtual_bool(b: CircuitBuilder):
    t = b.add_virtual_target()
    b.assert_bool(t)
    return t


def connect_hash(b: CircuitBuilder, x, y):
    for xi, yi in zip(x, y):
        b.connect(xi, yi)


def poseidon_two_to_one(b: CircuitBuilder, x, y):
    return b.two_to_one(x, y)


def calc_leaf_hash(b: CircuitBuilder, key, value):
    """hash_pad([k0..3, v0..3, 1]) == 12-wide permutation with ones at
    positions 8, 9, 11 (common.rs:87-101; native twin in smt/tree.py)."""
    one, zero = b.one(), b.zero()
    return b.hash_n_to_hash_no_pad(
        list(key) + list(value) + [one, one, zero, one])


def conditionally_reverse(b: CircuitBuilder, x, y, cond):
    """if cond { (y, x) } else { (x, y) } — fused arithmetic slots
    (common.rs:128-155)."""
    left, right = [], []
    for xi, yi in zip(x, y):
        delta = b.sub(yi, xi)
        left.append(b.arithmetic(1, 1, delta, cond, xi))
        right.append(b.arithmetic(gl.P - 1, 1, delta, cond, yi))
    return left, right


def conditionally_select(b: CircuitBuilder, x, y, cond):
    """if cond { x } else { y }."""
    return [b.select(cond, xi, yi) for xi, yi in zip(x, y)]


def calc_internal_hash(b: CircuitBuilder, child, sibling, swap):
    left, right = conditionally_reverse(b, child, sibling, swap)
    return poseidon_two_to_one(b, left, right)


def element_wise_add(b: CircuitBuilder, x, y):
    return [b.add(xi, yi) for xi, yi in zip(x, y)]


def element_wise_sub(b: CircuitBuilder, x, y):
    return [b.sub(xi, yi) for xi, yi in zip(x, y)]


def element_wise_mul(b: CircuitBuilder, x, y):
    return [b.mul(xi, yi) for xi, yi in zip(x, y)]


def scalar_mul_hash(b: CircuitBuilder, s, x):
    return [b.mul(s, xi) for xi in x]


def logical_and_not(b: CircuitBuilder, x, y):
    """x AND NOT(y) = x - x*y (one arithmetic slot, common.rs:211-221)."""
    return b.arithmetic(gl.P - 1, 1, x, y, x)


def logical_or(b: CircuitBuilder, x, y):
    return b.add(logical_and_not(b, x, y), y)


def material_implication(b: CircuitBuilder, x, y):
    return b.not_(logical_and_not(b, x, y))


def logical_nor(b: CircuitBuilder, x, y):
    return logical_and_not(b, b.not_(x), y)


def logical_xor(b: CircuitBuilder, x, y):
    """x + y - 2xy = x - (2xy - y) (common.rs:303-315)."""
    tmp = b.arithmetic(2, gl.P - 1, x, y, y)
    return b.sub(x, tmp)


def is_equal_hash_out(b: CircuitBuilder, left, right):
    out = b.one()
    for l, r in zip(left, right):
        out = b.and_(out, b.is_equal(l, r))
    return out


def count_hash(b: CircuitBuilder, search, targets):
    counter = b.zero()
    for t in targets:
        counter = b.add(counter, is_equal_hash_out(b, search, t))
    return counter


def enforce_equal_if_enabled(b: CircuitBuilder, left, right, enabled):
    eq = is_equal_hash_out(b, left, right)
    b.assert_zero(logical_and_not(b, enabled, eq))


def enforce_not_equal_if_enabled(b: CircuitBuilder, left, right, enabled):
    eq = is_equal_hash_out(b, left, right)
    b.assert_zero(b.and_(enabled, eq))


def smt_lev_ins(b: CircuitBuilder, enabled, siblings):
    """Insert-level detector (common.rs:373-432): levIns[i] marks the first
    level (from the leaf up) whose next-shallower sibling is nonzero."""
    num_levels = len(siblings)
    zero_h = zero_hash_t(b)
    is_zeros = [is_equal_hash_out(b, s, zero_h) for s in siblings]
    is_zeros.reverse()

    # deepest level must have a zero sibling when enabled
    b.assert_zero(logical_and_not(b, enabled, is_zeros[0]))

    lev_ins = [b.not_(is_zeros[1])]
    done = [lev_ins[0]]
    for i in range(1, num_levels - 1):
        is_non_zero = b.not_(is_zeros[i + 1])
        lev_ins.append(logical_and_not(b, is_non_zero, done[-1]))
        done.append(b.add(lev_ins[-1], done[-1]))
    lev_ins.append(b.not_(done[-1]))
    lev_ins.reverse()
    return lev_ins


def split_hash_to_bits(b: CircuitBuilder, h, n_bits=256):
    """LE bits of the 4x64-bit key encoding.  Only the elements that
    contribute path bits are decomposed (the reference splits all four,
    verify_smt.rs:240-242; the extra decompositions constrain nothing the
    state machine reads)."""
    bits = []
    for e in h:
        if len(bits) >= n_bits:
            break
        bits.extend(b.split_le(e, 64))
    return bits[:n_bits]


def set_hash_witness(pw: dict, target, value):
    for t, v in zip(target, value):
        pw[t] = v


# ------------------------------------------------------------------
# inclusion-proof circuit (verify/verify_smt.rs)
# ------------------------------------------------------------------

class VerifierLoopElt:
    def __init__(self, top, i0, i_old, i_new, na):
        self.top, self.i0, self.i_old, self.i_new, self.na = \
            top, i0, i_old, i_new, na


def smt_verifier_sm(b: CircuitBuilder, is0, lev_ins, fnc, prev):
    """(verify_smt.rs:157-211)"""
    aux1 = b.mul(prev.top, lev_ins)
    aux2 = b.mul(aux1, fnc)
    top = b.sub(prev.top, aux1)
    i_new = b.sub(aux1, aux2)
    i_old = b.mul(aux2, b.not_(is0))
    i0 = b.mul(aux1, is0)
    na = b.add(b.add(b.add(prev.na, prev.i_new), prev.i_old), prev.i0)
    return VerifierLoopElt(top, i0, i_old, i_new, na)


def smt_verifier_level(b: CircuitBuilder, st, sibling, old1_leaf, new1_leaf,
                       lr_bit, child):
    """root_i = hash*st_top + old1*st_i_old + new1*st_i_new
    (verify_smt.rs:106-155)."""
    hash_out = calc_internal_hash(b, child, sibling, lr_bit)
    root = []
    for a_i, b_i, c_i in zip(hash_out, old1_leaf, new1_leaf):
        acc = b.mul(a_i, st.top)
        acc = b.mul_add(b_i, st.i_old, acc)
        acc = b.mul_add(c_i, st.i_new, acc)
        root.append(acc)
    return root


def verify_smt_inclusion_proof(b: CircuitBuilder, siblings, root, old_key,
                               old_value, key, value, enabled, is_old0, fnc):
    """(verify_smt.rs:214-307).  fnc = 1 for a non-inclusion proof."""
    num_levels = len(siblings)
    hash1_old = calc_leaf_hash(b, old_key, old_value)
    hash1_new = calc_leaf_hash(b, key, value)
    n2b_new = split_hash_to_bits(b, key, num_levels)
    lev_ins = smt_lev_ins(b, enabled, siblings)

    false_t = b.zero()
    prev = VerifierLoopElt(enabled, false_t, false_t, false_t,
                           b.not_(enabled))
    sm = []
    for i in range(num_levels):
        prev = smt_verifier_sm(b, is_old0, lev_ins[i], fnc, prev)
        sm.append(prev)

    flag = b.add(b.add(sm[-1].na, sm[-1].i_old),
                 b.add(sm[-1].i_new, sm[-1].i0))
    b.assert_one(flag)

    child = zero_hash_t(b)
    for i in range(num_levels - 1, -1, -1):
        child = smt_verifier_level(b, sm[i], siblings[i], hash1_old,
                                   hash1_new, n2b_new[i], child)

    # non-inclusion with a different-leaf witness: key != old_key
    are_keys_equal = is_equal_hash_out(b, old_key, key)
    chk = logical_and_not(b, fnc, is_old0)
    chk = b.and_(chk, enabled)
    b.assert_zero(b.and_(chk, are_keys_equal))

    enforce_equal_if_enabled(b, root, child, enabled)


class SparseMerkleInclusionProofTarget:
    """(verify_smt.rs:28-96)"""

    def __init__(self, siblings, root, old_key, old_value, key, value,
                 enabled, is_old0, fnc):
        self.siblings = siblings
        self.root = root
        self.old_key = old_key
        self.old_value = old_value
        self.key = key
        self.value = value
        self.enabled = enabled
        self.is_old0 = is_old0
        self.fnc = fnc

    @classmethod
    def add_virtual_to(cls, b: CircuitBuilder, n_levels: int):
        siblings = add_virtual_hashes(b, n_levels)
        root = add_virtual_hash(b)
        old_key = add_virtual_hash(b)
        old_value = add_virtual_hash(b)
        key = add_virtual_hash(b)
        value = add_virtual_hash(b)
        enabled = add_virtual_bool(b)
        is_old0 = add_virtual_bool(b)
        fnc = add_virtual_bool(b)
        verify_smt_inclusion_proof(b, siblings, root, old_key, old_value,
                                   key, value, enabled, is_old0, fnc)
        return cls(siblings, root, old_key, old_value, key, value, enabled,
                   is_old0, fnc)

    def set_witness(self, pw: dict, proof, enabled: bool = True):
        if len(proof.siblings) >= len(self.siblings):
            raise ValueError("siblings too long")
        for i, st in enumerate(self.siblings):
            sib = proof.siblings[i] if i < len(proof.siblings) else (0,) * 4
            set_hash_witness(pw, st, sib)
        set_hash_witness(pw, self.root, proof.root)
        set_hash_witness(pw, self.old_key, proof.not_found_key)
        set_hash_witness(pw, self.old_value, proof.not_found_value)
        set_hash_witness(pw, self.key, proof.key)
        set_hash_witness(pw, self.value, proof.value)
        pw[self.enabled] = int(enabled)
        pw[self.is_old0] = int(proof.is_old0)
        pw[self.fnc] = int(not proof.found)


# ------------------------------------------------------------------
# process-proof circuit (process/process_smt.rs + utils.rs)
# ------------------------------------------------------------------

class ProcessMerkleProofRoleTarget:
    """Decode of fnc = [fnc0, fnc1] (utils.rs:12-56): NoOp=[0,0],
    Insert=[1,0], Update=[0,1], Delete=[1,1]."""

    def __init__(self, b: CircuitBuilder, fnc):
        fnc0, fnc1 = fnc
        self.is_no_op = logical_nor(b, fnc0, fnc1)
        self.is_insert_op = logical_and_not(b, fnc0, fnc1)
        self.is_update_op = logical_and_not(b, fnc1, fnc0)
        self.is_remove_op = b.and_(fnc0, fnc1)
        self.is_insert_or_update_op = logical_xor(b, fnc0, fnc1)
        self.is_remove_or_update_op = fnc1
        self.is_insert_or_no_op = b.not_(fnc1)
        self.is_remove_or_no_op = b.not_(self.is_insert_or_update_op)
        self.is_insert_or_remove_op = fnc0
        self.is_update_or_no_op = b.not_(fnc0)
        self.is_not_no_op = logical_or(b, fnc0, fnc1)


def get_process_merkle_proof_role(b: CircuitBuilder, fnc):
    return ProcessMerkleProofRoleTarget(b, fnc)


class ProcessorLoopElt:
    def __init__(self, top, old0, bot, new1, na, upd):
        self.top, self.old0, self.bot, self.new1, self.na, self.upd = \
            top, old0, bot, new1, na, upd


def smt_processor_sm(b: CircuitBuilder, xor, is0, lev_ins,
                     is_insert_or_remove_op, prev):
    """circomlib SMTProcessorSM transitions (process_smt.rs:454-525)."""
    aux1 = b.and_(prev.top, lev_ins)
    aux2 = b.and_(aux1, is_insert_or_remove_op)
    top = logical_and_not(b, prev.top, lev_ins)
    old0 = b.and_(aux2, is0)
    aux2_minus_old0 = logical_and_not(b, aux2, is0)
    branch = logical_or(b, aux2_minus_old0, prev.bot)
    new1 = b.and_(branch, xor)
    bot = logical_and_not(b, branch, xor)
    upd = logical_and_not(b, aux1, is_insert_or_remove_op)
    na = logical_or(b, logical_or(b, logical_or(b, prev.new1, prev.old0),
                                  prev.na), prev.upd)
    return ProcessorLoopElt(top, old0, bot, new1, na, upd)


def smt_processor_level(b: CircuitBuilder, st, sibling, old1_leaf, new1_leaf,
                        new_lr_bit, old_child, new_child):
    """Dual old/new root reconstruction, 2 Poseidons per level
    (process_smt.rs:353-436)."""
    zero_h = zero_hash_t(b)
    old_hash = calc_internal_hash(b, old_child, sibling, new_lr_bit)

    st_bot_new1_upd = b.add(b.add(st.bot, st.new1), st.upd)
    aux0 = conditionally_select(b, old1_leaf, zero_h, st_bot_new1_upd)
    a = conditionally_select(b, old_hash, zero_h, st.top)
    old_root = element_wise_add(b, a, aux0)

    st_top_or_bot = b.add(st.top, st.bot)
    aux1 = conditionally_select(b, new_child, zero_h, st_top_or_bot)
    bb = conditionally_select(b, new1_leaf, zero_h, st.new1)
    new_left = element_wise_add(b, bb, aux1)

    aux2 = conditionally_select(b, sibling, zero_h, st.top)
    c = conditionally_select(b, old1_leaf, zero_h, st.new1)
    new_right = element_wise_add(b, c, aux2)

    new_hash = calc_internal_hash(b, new_left, new_right, new_lr_bit)
    st_top_bot_new1 = b.add(st_top_or_bot, st.new1)
    aux3 = conditionally_select(b, new_hash, zero_h, st_top_bot_new1)
    st_old0_or_upd = b.add(st.old0, st.upd)
    d = conditionally_select(b, new1_leaf, zero_h, st_old0_or_upd)
    new_root = element_wise_add(b, d, aux3)

    return old_root, new_root


def verify_smt_process_proof_circuit(b: CircuitBuilder, siblings, old_root,
                                     old_key, old_value, new_root, new_key,
                                     new_value, is_old0, fnc):
    """(process_smt.rs:120-340)"""
    num_levels = len(siblings)
    false_t = b.zero()

    role = get_process_merkle_proof_role(b, fnc)
    is_remove_op = role.is_remove_op

    # delete = insert with old/new reversed
    fnc0 = fnc[0]
    fnc1 = b.select(is_remove_op, false_t, fnc[1])
    fnc = [fnc0, fnc1]
    old_key, new_key = conditionally_reverse(b, old_key, new_key,
                                             is_remove_op)
    old_value, new_value = conditionally_reverse(b, old_value, new_value,
                                                 is_remove_op)
    old_root_f, new_root_f = conditionally_reverse(b, old_root, new_root,
                                                   is_remove_op)

    role = get_process_merkle_proof_role(b, fnc)
    enabled = role.is_not_no_op
    b.assert_zero(role.is_remove_op)

    hash1_old = calc_leaf_hash(b, old_key, old_value)
    hash1_new = calc_leaf_hash(b, new_key, new_value)

    n2b_old = split_hash_to_bits(b, old_key, num_levels)
    n2b_new = split_hash_to_bits(b, new_key, num_levels)
    lev_ins = smt_lev_ins(b, enabled, siblings)
    xors = [logical_xor(b, a, bb) for a, bb in zip(n2b_old, n2b_new)]

    prev = ProcessorLoopElt(enabled, false_t, false_t, false_t,
                            b.not_(enabled), false_t)
    sm = []
    for i in range(num_levels):
        prev = smt_processor_sm(b, xors[i], is_old0, lev_ins[i],
                                role.is_insert_or_remove_op, prev)
        sm.append(prev)

    tmp1 = logical_or(b, sm[-1].na, sm[-1].new1)
    tmp2 = logical_or(b, sm[-1].old0, sm[-1].upd)
    b.assert_one(logical_or(b, tmp1, tmp2))

    prev_level = (zero_hash_t(b), zero_hash_t(b))
    for i in range(num_levels - 1, -1, -1):
        prev_level = smt_processor_level(b, sm[i], siblings[i], hash1_old,
                                         hash1_new, n2b_new[i],
                                         prev_level[0], prev_level[1])

    enforce_equal_if_enabled(b, prev_level[0], old_root_f, enabled)
    enforce_equal_if_enabled(b, prev_level[1], new_root_f, enabled)

    enforce_equal_if_enabled(b, old_key, new_key, role.is_update_or_no_op)
    enforce_equal_if_enabled(b, old_root_f, new_root_f, role.is_no_op)
    enforce_equal_if_enabled(b, old_value, new_value, role.is_no_op)


class SparseMerkleProcessProofTarget:
    """(process_smt.rs:27-120)"""

    def __init__(self, siblings, old_root, new_root, old_key, old_value,
                 new_key, new_value, is_old0, fnc):
        self.siblings = siblings
        self.old_root = old_root
        self.new_root = new_root
        self.old_key = old_key
        self.old_value = old_value
        self.new_key = new_key
        self.new_value = new_value
        self.is_old0 = is_old0
        self.fnc = fnc

    @classmethod
    def add_virtual_to(cls, b: CircuitBuilder, n_levels: int):
        siblings = add_virtual_hashes(b, n_levels)
        old_root = add_virtual_hash(b)
        old_key = add_virtual_hash(b)
        old_value = add_virtual_hash(b)
        new_root = add_virtual_hash(b)
        new_key = add_virtual_hash(b)
        new_value = add_virtual_hash(b)
        is_old0 = add_virtual_bool(b)
        fnc = [add_virtual_bool(b), add_virtual_bool(b)]
        verify_smt_process_proof_circuit(b, siblings, old_root, old_key,
                                         old_value, new_root, new_key,
                                         new_value, is_old0, fnc)
        return cls(siblings, old_root, new_root, old_key, old_value,
                   new_key, new_value, is_old0, fnc)

    def set_witness(self, pw: dict, proof):
        n_levels = len(self.siblings)
        if len(proof.siblings) >= n_levels:
            raise ValueError("siblings too long")
        if not proof.is_old0:
            idx = _first_different_bit_index(proof.old_key, proof.new_key)
            if idx is not None and idx >= n_levels:
                raise ValueError("invalid new_key")
        for i, st in enumerate(self.siblings):
            sib = proof.siblings[i] if i < len(proof.siblings) else (0,) * 4
            set_hash_witness(pw, st, sib)
        set_hash_witness(pw, self.old_root, proof.old_root)
        set_hash_witness(pw, self.new_root, proof.new_root)
        set_hash_witness(pw, self.old_key, proof.old_key)
        set_hash_witness(pw, self.old_value, proof.old_value)
        set_hash_witness(pw, self.new_key, proof.new_key)
        set_hash_witness(pw, self.new_value, proof.new_value)
        pw[self.is_old0] = int(proof.is_old0)
        f0, f1 = proof.fnc.bits
        pw[self.fnc[0]] = int(f0)
        pw[self.fnc[1]] = int(f1)


def _first_different_bit_index(a, bb):
    ba, bbits = key_to_bits(a), key_to_bits(bb)
    for i, (x, y) in enumerate(zip(ba, bbits)):
        if x != y:
            return i
    return None


def verify_smt_transition(b: CircuitBuilder, cur_fnc, prev_new_root,
                          cur_old_root):
    """Chained process proofs: cur.old_root == prev.new_root unless no-op
    (utils.rs:58-67)."""
    is_not_no_op = logical_or(b, cur_fnc[0], cur_fnc[1])
    enforce_equal_if_enabled(b, prev_new_root, cur_old_root, is_not_no_op)


def verify_layered_smt_target_connection(b: CircuitBuilder, upper_fnc,
                                         old_upper_value, new_upper_value,
                                         old_lower_root, new_lower_root):
    """Upper-value ↔ lower-root consistency per role (utils.rs:69-117)."""
    zero_h = zero_hash_t(b)
    role = get_process_merkle_proof_role(b, upper_fnc)
    enforce_equal_if_enabled(b, old_lower_root, zero_h,
                             role.is_insert_or_no_op)
    enforce_equal_if_enabled(b, new_lower_root, new_upper_value,
                             role.is_insert_or_update_op)
    enforce_equal_if_enabled(b, new_lower_root, zero_h,
                             role.is_remove_or_no_op)
    enforce_equal_if_enabled(b, old_lower_root, old_upper_value,
                             role.is_remove_or_update_op)
