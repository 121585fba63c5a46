"""BigUint gadget: multi-limb (32-bit) unsigned arithmetic in the circuit.

Host copy of `plonky2_tpu/gadgets/biguint.py` (the reference's two BigUint
gadgets, `nonnative/biguint.rs` and `ecdsa/gadgets/biguint.rs`, as one):
constant/connect/pad/cmp, add through a carry chain, sub (a >= b), the
schoolbook mul with column sums, mul by a u32 or a host constant, div_rem
through the `biguint_div_rem` hint re-verified as `a == div*b + rem`,
`rem < b`, and the bit split.

The functions taking `self` are attached to `CircuitBuilder` as methods at
import.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..witness import NamedGenerator
from ..witness.hints import big_from_int
from . import attach
from .u32 import U32Target


@dataclass
class BigUintTarget:
    limbs: list          # list[U32Target]

    @property
    def num_limbs(self) -> int:
        return len(self.limbs)

    def get_limb(self, i) -> U32Target:
        return self.limbs[i]


# ------------------------------------------------------------------


def constant_biguint(self, value: int) -> BigUintTarget:
    n = max(1, (value.bit_length() + 31) // 32)
    return BigUintTarget([self.constant_u32(l) for l in big_from_int(value, n)])


def zero_biguint(self) -> BigUintTarget:
    return self.constant_biguint(0)


def add_virtual_biguint_target(self, num_limbs: int) -> BigUintTarget:
    return BigUintTarget([self.add_virtual_u32_target() for _ in range(num_limbs)])


def connect_biguint(self, a: BigUintTarget, b: BigUintTarget) -> None:
    n = min(a.num_limbs, b.num_limbs)
    for i in range(n):
        self.connect_u32(a.limbs[i], b.limbs[i])
    for i in range(n, a.num_limbs):
        self.assert_zero_u32(a.limbs[i])
    for i in range(n, b.num_limbs):
        self.assert_zero_u32(b.limbs[i])


def pad_biguints(self, a: BigUintTarget, b: BigUintTarget):
    n = max(a.num_limbs, b.num_limbs)
    za = [self.zero_u32()] * (n - a.num_limbs)
    zb = [self.zero_u32()] * (n - b.num_limbs)
    return (BigUintTarget(a.limbs + za), BigUintTarget(b.limbs + zb))


def cmp_biguint(self, a: BigUintTarget, b: BigUintTarget):
    """Boolean target: a <= b (borrow chain of b - a)."""
    a, b = self.pad_biguints(a, b)
    borrow = self.zero_u32()
    for i in range(a.num_limbs):
        _, borrow = self.sub_u32(b.limbs[i], a.limbs[i], borrow)
    return self.not_(borrow.target)


def add_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """Full add: result has max(n_a, n_b) + 1 limbs."""
    a, b = self.pad_biguints(a, b)
    out = []
    carry = self.zero_u32()
    for i in range(a.num_limbs):
        s, carry = self.add_u32s_with_carry([a.limbs[i], b.limbs[i]], carry)
        out.append(s)
    out.append(carry)
    return BigUintTarget(out)


def add_biguint_nc(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """Add dropping the final carry (reference's `_nc` variant,
    reference src/nonnative/biguint.rs:199-221)."""
    r = self.add_biguint(a, b)
    return BigUintTarget(r.limbs[:-1])


def sub_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """a - b; assumes a >= b (final borrow is constrained to zero)."""
    a, b = self.pad_biguints(a, b)
    out = []
    borrow = self.zero_u32()
    for i in range(a.num_limbs):
        d, borrow = self.sub_u32(a.limbs[i], b.limbs[i], borrow)
        out.append(d)
    self.assert_zero(borrow.target)
    return BigUintTarget(out)


def mul_biguint_u32(self, a: BigUintTarget, s: U32Target) -> BigUintTarget:
    out = []
    carry = self.zero_u32()
    for i in range(a.num_limbs):
        lo, hi = self.mul_add_u32(a.limbs[i], s, carry)
        out.append(lo)
        carry = hi
    out.append(carry)
    return BigUintTarget(out)


def mul_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
    """Schoolbook with per-column batched carry adds
    (reference src/nonnative/biguint.rs:314-356 pattern)."""
    na, nb = a.num_limbs, b.num_limbs
    cols: list[list[U32Target]] = [[] for _ in range(na + nb)]
    for i in range(na):
        for j in range(nb):
            lo, hi = self.mul_u32(a.limbs[i], b.limbs[j])
            cols[i + j].append(lo)
            cols[i + j + 1].append(hi)
    out = []
    carry = self.zero_u32()
    for k in range(na + nb):
        terms = cols[k]
        if not terms:
            out.append(carry)
            carry = self.zero_u32()
            continue
        s, carry = self.add_u32s_with_carry(terms, carry)
        out.append(s)
    return BigUintTarget(out)


def sqr_biguint(self, a: BigUintTarget) -> BigUintTarget:
    return self.mul_biguint(a, a)


def shift_limbs_biguint(self, a: BigUintTarget, k: int) -> BigUintTarget:
    """a * 2^(32k): limb-shift, no gates."""
    return BigUintTarget([self.zero_u32()] * k + list(a.limbs))


def mul_biguint_by_const(self, a: BigUintTarget, c: int) -> BigUintTarget:
    """a * c for a host constant c, skipping zero limbs and turning
    one-limbs into pure shifts (used by the sparse-modulus overflow
    check in nonnative.py; the reference always pays the full schoolbook
    `mul_biguint(ovf, p)`, reference src/ecdsa/gadgets/
    nonnative.rs:313-342)."""
    if c == 0:
        return self.zero_biguint()
    limbs_c = big_from_int(c, (c.bit_length() + 31) // 32)
    acc = None
    for i, cl in enumerate(limbs_c):
        if cl == 0:
            continue
        if cl == 1:
            part = BigUintTarget(list(a.limbs))
        else:
            part = self.mul_biguint_u32(a, self.constant_u32(cl))
        part = self.shift_limbs_biguint(part, i)
        acc = part if acc is None else self.add_biguint(acc, part)
    return acc


def assert_biguint_nonzero(self, a: BigUintTarget) -> None:
    """Constrain a != 0: the Goldilocks sum of the (canonical u32) limbs
    is zero iff every limb is zero; assert it has an inverse."""
    s = self.add_many([t.target for t in a.limbs])
    w = self.add_virtual_target()
    self.add_simple_generator(NamedGenerator("inv_or_zero", {}, [s], [w]))
    self.assert_one(self.mul(s, w))


def div_rem_biguint(self, a: BigUintTarget, b: BigUintTarget):
    """(div, rem) via hint; re-verified with `a == div*b + rem`, `rem < b`."""
    n_div = a.num_limbs
    n_rem = b.num_limbs
    div = self.add_virtual_biguint_target(n_div)
    rem = self.add_virtual_biguint_target(n_rem)

    deps = [t.target for t in a.limbs] + [t.target for t in b.limbs]
    self.add_simple_generator(NamedGenerator(
        "biguint_div_rem", {"na": a.num_limbs, "nb": b.num_limbs}, deps,
        [t.target for t in div.limbs + rem.limbs]))

    prod = self.mul_biguint(div, b)
    total = self.add_biguint(prod, rem)
    self.connect_biguint(total, a)
    lt = self.cmp_biguint(b, rem)        # b <= rem must be false
    self.assert_zero(lt)
    return div, rem


def div_biguint(self, a, b):
    return self.div_rem_biguint(a, b)[0]


def rem_biguint(self, a, b):
    return self.div_rem_biguint(a, b)[1]


def split_biguint_to_bits(self, a: BigUintTarget) -> list:
    """Little-endian bits of all limbs
    (reference src/nonnative/biguint.rs:423-440)."""
    bits = []
    for limb in a.limbs:
        bits.extend(self.split_le(limb.target, 32))
    return bits


# witness-side helpers ------------------------------------------------

def set_biguint_target(inputs: dict, target: BigUintTarget, value: int):
    for i, t in enumerate(target.limbs):
        inputs[t.target] = (value >> (32 * i)) & 0xFFFFFFFF


# ------------------------------------------------------------------
# attach to CircuitBuilder
# ------------------------------------------------------------------

attach(globals())
