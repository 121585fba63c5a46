"""secp256k1 curve gadgets: point operations, the windowed, fixed-base
and GLV scalar multiplications, and the dual-scalar MSM.

Host copy of `plonky2_tpu/gadgets/curve.py` (the reference's
`ecdsa/gadgets/curve.rs`, `curve_windowed_mul.rs`, `curve_fixed_base.rs`,
`curve_msm.rs` and `glv.rs`).  The table selects go through
RandomAccessGate, one packed gate copy a limb.

Incomplete arithmetic: add and double assume distinct, non-negated,
non-infinity operands, as the reference does; blinding offsets keep honest
traces away from those cases.  The blinding points are derived from
SHA-256 (`deterministic_point`), so every build of a circuit is the same.

The functions taking `self` are attached to `CircuitBuilder` as methods at
import.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..field import secp
from ..witness import NamedGenerator
from . import attach
from .biguint import BigUintTarget
from .nonnative import NonNativeTarget
from .u32 import U32Target


@dataclass
class AffinePointTarget:
    x: NonNativeTarget
    y: NonNativeTarget


def deterministic_point(tag: str) -> secp.Point:
    """Try-and-increment from SHA-256(tag): a curve point nobody controls
    (replaces the reference's KeccakHash(0) / rand() blinding points)."""
    ctr = 0
    while True:
        h = int.from_bytes(hashlib.sha256(f"{tag}/{ctr}".encode()).digest(),
                           "big") % secp.P
        rhs = (h * h * h + secp.B) % secp.P
        y = pow(rhs, (secp.P + 1) // 4, secp.P)
        if y * y % secp.P == rhs:
            return secp.Point(h, y)
        ctr += 1


BLIND = deterministic_point("plonky2_tpu/curve/blind/v1")


# ------------------------------------------------------------------

def constant_affine_point(self, p: secp.Point) -> AffinePointTarget:
    assert not p.inf
    return AffinePointTarget(self.constant_nonnative(p.x, secp.P),
                             self.constant_nonnative(p.y, secp.P))


def add_virtual_affine_point_target(self) -> AffinePointTarget:
    return AffinePointTarget(self.add_virtual_nonnative_target(secp.P),
                             self.add_virtual_nonnative_target(secp.P))


def connect_affine_point(self, a: AffinePointTarget, b: AffinePointTarget):
    self.connect_nonnative(a.x, b.x)
    self.connect_nonnative(a.y, b.y)


def curve_assert_valid(self, p: AffinePointTarget):
    """y^2 == x^3 + 7 (curve.rs:104-116)."""
    y2 = self.mul_nonnative(p.y, p.y)
    x2 = self.mul_nonnative(p.x, p.x)
    x3 = self.mul_nonnative(x2, p.x)
    rhs = self.add_nonnative(x3, self.constant_nonnative(secp.B, secp.P))
    self.connect_nonnative(y2, rhs)


def curve_neg(self, p: AffinePointTarget) -> AffinePointTarget:
    return AffinePointTarget(p.x, self.neg_nonnative(p.y))


def curve_conditional_neg(self, p: AffinePointTarget, cond) -> AffinePointTarget:
    return AffinePointTarget(p.x, self.nonnative_conditional_neg(p.y, cond))


def curve_double(self, p: AffinePointTarget) -> AffinePointTarget:
    # lambda = 3x^2 / 2y ; x3 = l^2 - 2x ; y3 = l(x - x3) - y.
    # The quotient is hinted and re-verified (div_hint_nonnative), one
    # mul cheaper than the reference's inv-then-mul (curve.rs:137-159).
    x2 = self.mul_nonnative(p.x, p.x)
    three_x2 = self.add_many_nonnative([x2, x2, x2])
    two_y = self.add_nonnative(p.y, p.y)
    lam = self.div_hint_nonnative(three_x2, two_y)
    lam2 = self.mul_nonnative(lam, lam)
    x3 = self.sub_nonnative(self.sub_nonnative(lam2, p.x), p.x)
    y3 = self.sub_nonnative(self.mul_nonnative(lam, self.sub_nonnative(p.x, x3)),
                            p.y)
    return AffinePointTarget(x3, y3)


def curve_add(self, p1: AffinePointTarget, p2: AffinePointTarget) -> AffinePointTarget:
    """Incomplete: assumes p1 != +-p2 and neither is infinity."""
    dy = self.sub_nonnative(p2.y, p1.y)
    dx = self.sub_nonnative(p2.x, p1.x)
    # hinted quotient (verifies lam*dx == dy and dx != 0; see curve_double)
    lam = self.div_hint_nonnative(dy, dx)
    lam2 = self.mul_nonnative(lam, lam)
    x3 = self.sub_nonnative(self.sub_nonnative(lam2, p1.x), p2.x)
    y3 = self.sub_nonnative(self.mul_nonnative(lam, self.sub_nonnative(p1.x, x3)),
                            p1.y)
    return AffinePointTarget(x3, y3)


def curve_conditional_add(self, p1: AffinePointTarget, p2: AffinePointTarget,
                          cond) -> AffinePointTarget:
    s = self.curve_add(p1, p2)
    return AffinePointTarget(self.if_nonnative(cond, s.x, p1.x),
                            self.if_nonnative(cond, s.y, p1.y))


def if_affine_point(self, cond, a: AffinePointTarget, b: AffinePointTarget):
    return AffinePointTarget(self.if_nonnative(cond, a.x, b.x),
                            self.if_nonnative(cond, a.y, b.y))


# ------------------------------------------------------------------
# scalar multiplication
# ------------------------------------------------------------------

def curve_scalar_mul(self, p: AffinePointTarget, n: NonNativeTarget) -> AffinePointTarget:
    """Naive double-and-add with blinded accumulator (curve.rs:216-255)."""
    bits = self.split_nonnative_to_bits(n)       # LSB first
    acc = self.constant_affine_point(BLIND)
    q = p
    for i, bit in enumerate(bits):
        acc = self.curve_conditional_add(acc, q, bit)
        if i + 1 < len(bits):
            q = self.curve_double(q)
    return self.curve_add(acc, self.constant_affine_point(secp.neg(BLIND)))


def random_access_nonnative(self, index, values: list) -> NonNativeTarget:
    """Per-limb RandomAccessGate select over nonnative values — the
    reference's per-limb `random_access` (curve_windowed_mul.rs:73-117),
    one packed gate copy per limb instead of a 2^k select-gate mux tree."""
    num_limbs = values[0].value.num_limbs
    modulus = values[0].modulus
    assert all(v.value.num_limbs == num_limbs for v in values)
    limbs = [U32Target(self.random_access(
        index, [v.value.limbs[i].target for v in values]))
        for i in range(num_limbs)]
    return NonNativeTarget(BigUintTarget(limbs), modulus)


def random_access_curve_points(self, index, points: list) -> AffinePointTarget:
    """(curve_windowed_mul.rs:73-117) — select one of 2^k points."""
    xs = self.random_access_nonnative(index, [p.x for p in points])
    ys = self.random_access_nonnative(index, [p.y for p in points])
    return AffinePointTarget(xs, ys)


def precompute_window(self, p: AffinePointTarget, window_bits: int,
                      blind: secp.Point) -> list:
    """[blind, blind+p, blind+2p, ...] (curve_windowed_mul.rs:52-71)."""
    table = [self.constant_affine_point(blind)]
    for _ in range((1 << window_bits) - 1):
        table.append(self.curve_add(table[-1], p))
    return table


def curve_scalar_mul_windowed(self, p: AffinePointTarget,
                              n: NonNativeTarget) -> AffinePointTarget:
    """4-bit windowed variable-base mul (curve_windowed_mul.rs:130-169)."""
    limbs = self.split_nonnative_to_4_bit_limbs(n)   # 64 limbs, LSB first
    table = self.precompute_window(p, 4, BLIND)
    acc = None
    extra = 0        # accumulated multiples of BLIND to strip at the end
    for w in reversed(range(len(limbs))):
        if acc is not None:
            for _ in range(4):
                acc = self.curve_double(acc)
                extra *= 2
        entry = self.random_access_curve_points(limbs[w], table)
        acc = entry if acc is None else self.curve_add(acc, entry)
        extra += 1
    correction = secp.mul(BLIND, extra)
    return self.curve_add(acc, self.constant_affine_point(secp.neg(correction)))


def fixed_base_curve_mul(self, base: secp.Point,
                         n: NonNativeTarget) -> AffinePointTarget:
    """Fixed-base 4-bit windowed mul with constant tables
    (curve_fixed_base.rs:18-66)."""
    limbs = self.split_nonnative_to_4_bit_limbs(n)   # 64 limbs, LSB first
    acc = self.constant_affine_point(BLIND)
    extra = 1
    for w, limb in enumerate(limbs):
        step = secp.mul(base, 1 << (4 * w))
        blind_w = deterministic_point(f"plonky2_tpu/fixed_base/{w}")
        tbl = []
        cur = blind_w
        for j in range(16):
            tbl.append(self.constant_affine_point(cur))
            cur = secp.add(cur, step)
        entry = self.random_access_curve_points(limb, tbl)
        acc = self.curve_add(acc, entry)
    correction = BLIND
    for w in range(len(limbs)):
        correction = secp.add(correction,
                              deterministic_point(f"plonky2_tpu/fixed_base/{w}"))
    return self.curve_add(acc, self.constant_affine_point(secp.neg(correction)))


# ------------------------------------------------------------------
# dual-scalar MSM + GLV (curve_msm.rs, glv.rs)
# ------------------------------------------------------------------

def split_nonnative_to_2_bit_limbs_bounded(self, a: NonNativeTarget,
                                           num_bits: int) -> list:
    """2-bit windows of the low `num_bits` bits; simultaneously
    range-constrains a < 2^num_bits (the partial BaseSum row bounds the
    boundary limb, higher limbs are asserted zero)."""
    windows = (num_bits + 1) // 2
    out = []
    for t in a.value.limbs:
        remaining = windows - len(out)
        if remaining <= 0:
            self.assert_zero(t.target)
            continue
        out.extend(self.split_le_base(4, t.target, min(16, remaining)))
    return out


def curve_msm(self, p: AffinePointTarget, q: AffinePointTarget,
              n: NonNativeTarget, m: NonNativeTarget,
              num_bits: int | None = None) -> AffinePointTarget:
    """n*p + m*q with 2-bit windows and a shared doubling chain
    (curve_msm.rs:21-79).  Doesn't work if p == q (same caveat).

    `num_bits` bounds the scalars: the split range-checks n, m < 2^num_bits
    and the doubling chain only covers that many bits.  The reference
    always walks all 256 bits even for GLV half-scalars (curve_msm.rs
    splits the full NonNativeTarget) — passing 130 here halves the chain,
    which is the entire point of the GLV split."""
    if num_bits is None:
        limbs_n = self.split_nonnative_to_2_bit_limbs(n)   # 128, LSB first
        limbs_m = self.split_nonnative_to_2_bit_limbs(m)
    else:
        limbs_n = self.split_nonnative_to_2_bit_limbs_bounded(n, num_bits)
        limbs_m = self.split_nonnative_to_2_bit_limbs_bounded(m, num_bits)
    assert len(limbs_n) == len(limbs_m)
    # table[i + 4j] = i*p + j*q + BLIND
    table = []
    row0 = [self.constant_affine_point(BLIND)]
    for i in range(3):
        row0.append(self.curve_add(row0[-1], p))
    table.extend(row0)
    prev = row0
    for j in range(3):
        row = [self.curve_add(e, q) for e in prev]
        table.extend(row)
        prev = row
    acc = None
    extra = 0
    for w in reversed(range(len(limbs_n))):
        if acc is not None:
            acc = self.curve_double(self.curve_double(acc))
            extra *= 4
        # table index = limb_n + 4*limb_m
        idx = self.arithmetic(4, 1, limbs_m[w], self.one(), limbs_n[w])
        entry = self.random_access_curve_points(idx, table)
        acc = entry if acc is None else self.curve_add(acc, entry)
        extra += 1
    correction = secp.mul(BLIND, extra)
    return self.curve_add(acc, self.constant_affine_point(secp.neg(correction)))


def decompose_secp256k1_scalar(self, k: NonNativeTarget):
    """GLV hint + in-circuit check k1' + lambda*k2' == k (glv.rs:51-83).
    Returns (k1, k2, k1_neg, k2_neg) with k1/k2 the magnitudes mod N."""
    FN = secp.N
    k1 = self.add_virtual_nonnative_target(FN)
    k2 = self.add_virtual_nonnative_target(FN)
    k1_neg = self.add_virtual_target()
    k2_neg = self.add_virtual_target()

    self.add_simple_generator(NamedGenerator(
        "glv_decompose", {"n1": k1.num_limbs, "n2": k2.num_limbs},
        [t.target for t in k.value.limbs],
        [t.target for t in k1.value.limbs + k2.value.limbs]
        + [k1_neg, k2_neg]))
    self.assert_bool(k1_neg)
    self.assert_bool(k2_neg)
    k1s = self.nonnative_conditional_neg(k1, k1_neg)
    k2s = self.nonnative_conditional_neg(k2, k2_neg)
    lam = self.constant_nonnative(secp.GLV_LAMBDA, FN)
    rhs = self.add_nonnative(k1s, self.mul_nonnative(lam, k2s))
    self.connect_nonnative(rhs, k)
    return k1, k2, k1_neg, k2_neg


def glv_mul(self, p: AffinePointTarget, k: NonNativeTarget) -> AffinePointTarget:
    """k*p via GLV: k1*p' + k2*psi(p') with half-length scalars
    (glv.rs:85-102)."""
    k1, k2, k1_neg, k2_neg = self.decompose_secp256k1_scalar(k)
    beta = self.constant_nonnative(secp.GLV_BETA, secp.P)
    p1 = self.curve_conditional_neg(p, k1_neg)
    endo = AffinePointTarget(self.mul_nonnative(beta, p.x), p.y)
    p2 = self.curve_conditional_neg(endo, k2_neg)
    # GLV magnitudes are < 2^129 (Alg 15.41 bound; native max observed
    # 129 bits) — the bounded msm range-checks them and walks 65 windows
    # instead of the reference's 128 (curve_msm.rs splits all 256 bits).
    return self.curve_msm(p1, p2, k1, k2, num_bits=130)


# ------------------------------------------------------------------
# attach to CircuitBuilder
# ------------------------------------------------------------------

attach(globals())
