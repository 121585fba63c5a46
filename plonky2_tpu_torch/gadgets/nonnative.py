"""Non-native prime-field arithmetic gadget.

Host copy of `plonky2_tpu/gadgets/nonnative.py` (the reference's
`ecdsa/gadgets/nonnative.rs` and `split_nonnative.rs`): a `NonNativeTarget`
wraps a BigUintTarget and carries its modulus; every mod-p operation is
hint-and-verify (a hint computes the reduced value on the host, the
circuit re-checks `a + b = sum + ovf*p`, `a*b = prod + ovf*p`,
`x*inv = 1 + div*p` with biguint arithmetic and range-checks the result
below p).  For a sparse modulus (secp256k1's p and n) `ovf*p` becomes
shifts and a narrow constant product (`_sparse_d`).  Also the 2- and 4-bit
limb splits of the scalar multiplications.

The functions taking `self` are attached to `CircuitBuilder` as methods at
import.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..witness import NamedGenerator
from ..witness.hints import big_from_int
from . import attach
from .biguint import BigUintTarget
from .u32 import U32Target


@dataclass
class NonNativeTarget:
    value: BigUintTarget
    modulus: int

    @property
    def num_limbs(self):
        return self.value.num_limbs


def _mod_limbs(modulus: int) -> int:
    return (modulus.bit_length() + 31) // 32


def _sparse_d(p: int):
    """For p = 2^(32k) - d with a narrow d (secp256k1: d = 2^32 + 977;
    its scalar field: d 129 bits), the overflow product `ovf * p` in every
    hint-and-verify identity can be replaced by shifts and a small constant
    multiply:  X == Y + ovf*p  <=>  X + ovf*d == Y + ovf*2^(32k), where the
    right side is a free limb-concatenation.  Returns (k, d) with d=None
    when the modulus is not sparse enough to profit (then callers use the
    reference's full `mul_biguint(ovf, p)` formulation,
    reference src/ecdsa/gadgets/nonnative.rs:313-342)."""
    k = _mod_limbs(p)
    d = (1 << (32 * k)) - p
    return (k, d) if d.bit_length() <= 32 * (k - 2) else (k, None)


def _limb_targets(b: BigUintTarget):
    return [t.target for t in b.limbs]


def _bool_times_const(b, ovf, d: int) -> BigUintTarget:
    """ovf * d for a bool target ovf: each limb is select(ovf, d_i, 0),
    one base arithmetic op per nonzero limb of d."""
    limbs = []
    for dl in big_from_int(d, _mod_limbs(d)):
        limbs.append(b.zero_u32() if dl == 0
                     else U32Target(b.mul_const(dl, ovf)))
    return BigUintTarget(limbs)


# ------------------------------------------------------------------

def add_virtual_nonnative_target(self, modulus: int) -> NonNativeTarget:
    v = self.add_virtual_biguint_target(_mod_limbs(modulus))
    return NonNativeTarget(v, modulus)


def constant_nonnative(self, value: int, modulus: int) -> NonNativeTarget:
    value %= modulus
    limbs = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(_mod_limbs(modulus))]
    return NonNativeTarget(
        BigUintTarget([self.constant_u32(l) for l in limbs]), modulus)


def zero_nonnative(self, modulus: int) -> NonNativeTarget:
    return self.constant_nonnative(0, modulus)


def connect_nonnative(self, a: NonNativeTarget, b: NonNativeTarget):
    self.connect_biguint(a.value, b.value)


def assert_nonnative_lt_modulus(self, a: NonNativeTarget):
    """Range check a < modulus."""
    p_c = self.constant_biguint(a.modulus)
    self.assert_zero(self.cmp_biguint(p_c, a.value))   # NOT (p <= a)


def biguint_to_nonnative(self, b: BigUintTarget, modulus: int) -> NonNativeTarget:
    """Interpret (must already be < modulus; not range checked here)."""
    return NonNativeTarget(b, modulus)


def nonnative_to_canonical_biguint(self, a: NonNativeTarget) -> BigUintTarget:
    return a.value


def reduce_biguint(self, b: BigUintTarget, modulus: int) -> NonNativeTarget:
    """b mod modulus via div_rem (reference src/ecdsa/gadgets/nonnative.rs:392-402)."""
    p_c = self.constant_biguint(modulus)
    rem = self.rem_biguint(b, p_c)
    return NonNativeTarget(rem, modulus)


def add_nonnative(self, a: NonNativeTarget, b: NonNativeTarget) -> NonNativeTarget:
    """Hint sum + bool overflow; verify a + b == sum + ovf*p; sum < p."""
    p = a.modulus
    out = self.add_virtual_nonnative_target(p)
    ovf = self.add_virtual_target()

    self.add_simple_generator(NamedGenerator(
        "nn_add", {"p": p, "nl": a.num_limbs, "n_out": out.num_limbs},
        _limb_targets(a.value) + _limb_targets(b.value),
        _limb_targets(out.value) + [ovf]))
    self.assert_bool(ovf)
    k, d = _sparse_d(p)
    if d is not None:
        # a + b + ovf*d == out + ovf*2^(32k); bool ovf makes ovf*d a plain
        # per-limb arithmetic multiply and the right side a concatenation.
        lhs = self.add_biguint(self.add_biguint(a.value, b.value),
                               _bool_times_const(self, ovf, d))
        rhs = BigUintTarget(list(out.value.limbs) + [U32Target(ovf)])
    else:
        lhs = self.add_biguint(a.value, b.value)
        p_c = self.constant_biguint(p)
        ovf_p = self.mul_biguint_u32(p_c, U32Target(ovf))
        rhs = self.add_biguint(out.value, ovf_p)
    self.connect_biguint(lhs, rhs)
    self.assert_nonnative_lt_modulus(out)
    return out


def add_many_nonnative(self, xs: list) -> NonNativeTarget:
    """Hint result + small u32 overflow (reference :241-282)."""
    p = xs[0].modulus
    out = self.add_virtual_nonnative_target(p)
    ovf = self.add_virtual_u32_target()
    deps = [t for x in xs for t in _limb_targets(x.value)]
    self.add_simple_generator(NamedGenerator(
        "nn_add_many",
        {"p": p, "nl": [x.num_limbs for x in xs], "n_out": out.num_limbs},
        deps, _limb_targets(out.value) + [ovf.target]))
    lhs = xs[0].value
    for x in xs[1:]:
        lhs = self.add_biguint(lhs, x.value)
    k, d = _sparse_d(p)
    if d is not None:
        # sum(xs) + ovf*d == out + ovf*2^(32k), u32 overflow.
        lhs = self.add_biguint(
            lhs, self.mul_biguint_by_const(BigUintTarget([ovf]), d))
        rhs = BigUintTarget(list(out.value.limbs) + [ovf])
    else:
        p_c = self.constant_biguint(p)
        rhs = self.add_biguint(out.value, self.mul_biguint_u32(p_c, ovf))
    self.connect_biguint(lhs, rhs)
    self.assert_nonnative_lt_modulus(out)
    return out


def sub_nonnative(self, a: NonNativeTarget, b: NonNativeTarget) -> NonNativeTarget:
    """Hint diff + bool ovf; verify a + ovf*p == b + diff; diff < p."""
    p = a.modulus
    out = self.add_virtual_nonnative_target(p)
    ovf = self.add_virtual_target()

    self.add_simple_generator(NamedGenerator(
        "nn_sub", {"p": p, "nl": a.num_limbs, "n_out": out.num_limbs},
        _limb_targets(a.value) + _limb_targets(b.value),
        _limb_targets(out.value) + [ovf]))
    self.assert_bool(ovf)
    k, d = _sparse_d(p)
    if d is not None:
        # a + ovf*2^(32k) == b + diff + ovf*d: left side is free.
        lhs = BigUintTarget(list(a.value.limbs) + [U32Target(ovf)])
        rhs = self.add_biguint(self.add_biguint(b.value, out.value),
                               _bool_times_const(self, ovf, d))
    else:
        p_c = self.constant_biguint(p)
        lhs = self.add_biguint(a.value,
                               self.mul_biguint_u32(p_c, U32Target(ovf)))
        rhs = self.add_biguint(b.value, out.value)
    self.connect_biguint(lhs, rhs)
    self.assert_nonnative_lt_modulus(out)
    return out


def neg_nonnative(self, a: NonNativeTarget) -> NonNativeTarget:
    return self.sub_nonnative(self.zero_nonnative(a.modulus), a)


def mul_nonnative(self, a: NonNativeTarget, b: NonNativeTarget) -> NonNativeTarget:
    """Hint prod + overflow biguint; verify a*b == prod + ovf*p; prod < p."""
    p = a.modulus
    out = self.add_virtual_nonnative_target(p)
    n_ovf = a.num_limbs + b.num_limbs - _mod_limbs(p) + 1
    ovf = self.add_virtual_biguint_target(n_ovf)

    self.add_simple_generator(NamedGenerator(
        "nn_mul", {"p": p, "nl": a.num_limbs, "n_out": out.num_limbs,
                   "n_ovf": n_ovf},
        _limb_targets(a.value) + _limb_targets(b.value),
        _limb_targets(out.value) + _limb_targets(ovf)))
    lhs = self.mul_biguint(a.value, b.value)
    k, d = _sparse_d(p)
    if d is not None:
        # a*b + ovf*d == out + ovf*2^(32k): the dominant `ovf * p`
        # schoolbook of the reference collapses to a narrow constant
        # multiply plus a limb concatenation.
        lhs = self.add_biguint(lhs, self.mul_biguint_by_const(ovf, d))
        rhs = BigUintTarget(list(out.value.limbs) + list(ovf.limbs))
    else:
        p_c = self.constant_biguint(p)
        rhs = self.add_biguint(self.mul_biguint(ovf, p_c), out.value)
    self.connect_biguint(lhs, rhs)
    self.assert_nonnative_lt_modulus(out)
    return out


def sqr_nonnative(self, a: NonNativeTarget) -> NonNativeTarget:
    return self.mul_nonnative(a, a)


def inv_nonnative(self, x: NonNativeTarget) -> NonNativeTarget:
    """Hint inv + div; verify x*inv == 1 + div*p (reference :366-390).

    Note: also forces x != 0 (no inverse satisfies the identity)."""
    p = x.modulus
    inv = self.add_virtual_nonnative_target(p)
    n_div = 2 * x.num_limbs - _mod_limbs(p) + 1
    div = self.add_virtual_biguint_target(n_div)

    self.add_simple_generator(NamedGenerator(
        "nn_inv", {"p": p, "n_inv": inv.num_limbs, "n_div": n_div},
        _limb_targets(x.value),
        _limb_targets(inv.value) + _limb_targets(div)))
    prod = self.mul_biguint(x.value, inv.value)
    k, d = _sparse_d(p)
    if d is not None:
        # x*inv + div*d == 1 + div*2^(32k)
        lhs = self.add_biguint(prod, self.mul_biguint_by_const(div, d))
        rhs = BigUintTarget([self.constant_u32(1)]
                            + [self.zero_u32()] * (k - 1) + list(div.limbs))
        self.connect_biguint(lhs, rhs)
    else:
        p_c = self.constant_biguint(p)
        rhs = self.add_biguint(self.mul_biguint(div, p_c),
                               self.constant_biguint(1))
        self.connect_biguint(prod, rhs)
    self.assert_nonnative_lt_modulus(inv)
    return inv


def div_nonnative(self, a: NonNativeTarget, b: NonNativeTarget) -> NonNativeTarget:
    return self.mul_nonnative(a, self.inv_nonnative(b))


def div_hint_nonnative(self, a: NonNativeTarget,
                       b: NonNativeTarget) -> NonNativeTarget:
    """a / b mod p via a single hinted quotient: hint q = a*b^-1, verify
    q*b == a (one mul_nonnative) and b != 0.  One multiplication cheaper
    than the reference's inv-then-mul (nonnative.rs:366-390 + a mul);
    carries the same b != 0 soundness (the reference's `x*inv == 1 + div*p`
    identity is unsatisfiable at x == 0; here the explicit nonzero check
    plays that role, since `q*0 == 0 == a` would otherwise admit any q).

    PRECONDITION: b is canonical (b < p).  The nonzero check is on b's
    limbs as an integer, so b == p (zero mod p, nonzero limbs) would pass
    it and, with a == 0, admit any q.  The call sites (`curve_add`,
    `curve_double`) pass outputs of `sub_nonnative` and `add_nonnative`,
    which are range-checked below p.  The JAX package checks no range
    here, and one more check would change the circuit and so the proof
    bytes, so the port follows it gate for gate."""
    p = a.modulus
    out = self.add_virtual_nonnative_target(p)
    self.add_simple_generator(NamedGenerator(
        "nn_div", {"p": p, "nl": a.num_limbs, "n_out": out.num_limbs},
        _limb_targets(a.value) + _limb_targets(b.value),
        _limb_targets(out.value)))
    self.assert_biguint_nonzero(b.value)
    prod = self.mul_nonnative(out, b)
    self.connect_nonnative(prod, a)
    return out


# ---------------- conditionals ----------------

def if_nonnative(self, cond, a: NonNativeTarget, b: NonNativeTarget) -> NonNativeTarget:
    """cond ? a : b (element-wise limb select)."""
    a_v, b_v = self.pad_biguints(a.value, b.value)
    limbs = [U32Target(self.select(cond, x.target, y.target))
             for x, y in zip(a_v.limbs, b_v.limbs)]
    return NonNativeTarget(BigUintTarget(limbs), a.modulus)


def mul_nonnative_by_bool(self, a: NonNativeTarget, cond) -> NonNativeTarget:
    limbs = [U32Target(self.mul(t.target, cond)) for t in a.value.limbs]
    return NonNativeTarget(BigUintTarget(limbs), a.modulus)


def nonnative_conditional_neg(self, a: NonNativeTarget, cond) -> NonNativeTarget:
    neg = self.neg_nonnative(a)
    return self.if_nonnative(cond, neg, a)


# ---------------- bit/limb splitting ----------------

def split_nonnative_to_bits(self, a: NonNativeTarget) -> list:
    return self.split_biguint_to_bits(a.value)


def split_u32_to_4_bit_limbs(self, x: U32Target) -> list:
    """(reference src/ecdsa/gadgets/split_nonnative.rs:38-48):
    base-4 split then pairwise recombine into 8 4-bit limbs."""
    two_bit = self.split_le_base(4, x.target, 16)
    out = []
    for i in range(8):
        out.append(self.mul_add(self.constant(4), two_bit[2 * i + 1],
                                two_bit[2 * i]))
    return out


def split_nonnative_to_4_bit_limbs(self, a: NonNativeTarget) -> list:
    limbs = []
    for t in a.value.limbs:
        limbs.extend(self.split_u32_to_4_bit_limbs(t))
    return limbs


def split_nonnative_to_2_bit_limbs(self, a: NonNativeTarget) -> list:
    limbs = []
    for t in a.value.limbs:
        limbs.extend(self.split_le_base(4, t.target, 16))
    return limbs


def recombine_nonnative_4_bit_limbs(self, limbs: list, modulus: int) -> NonNativeTarget:
    out = []
    for i in range(0, len(limbs), 8):
        chunk = limbs[i:i + 8]
        acc = self.zero()
        for l in reversed(chunk):
            acc = self.mul_add(self.constant(16), acc, l)
        out.append(U32Target(acc))
    return NonNativeTarget(BigUintTarget(out), modulus)


# ------------------------------------------------------------------
# attach to CircuitBuilder
# ------------------------------------------------------------------

attach(globals())
