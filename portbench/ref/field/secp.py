"""Native secp256k1 arithmetic on Python ints: the witness oracle.

Host copy of `plonky2_tpu/field/secp.py` (the reference's `ecdsa/curve/`:
the affine group law, the curve constants, ECDSA sign and verify, and the
GLV decomposition).  Jacobian `pj_*` operations and Montgomery batch
inversion serve the scalar multiplications; the code runs in witness
generators and in the tests, never on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

# Field and curve constants (secp256k1: y^2 = x^3 + 7)
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
A = 0
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# GLV endomorphism: (x, y) -> (beta*x, y) equals multiplication by lambda
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72


@dataclass(frozen=True)
class Point:
    x: int
    y: int
    inf: bool = False

    def is_valid(self) -> bool:
        if self.inf:
            return True
        return (self.y * self.y - self.x ** 3 - A * self.x - B) % P == 0


ZERO = Point(0, 0, True)
G = Point(GX, GY)


def inv_p(x: int) -> int:
    return pow(x, P - 2, P)


def inv_n(x: int) -> int:
    return pow(x, N - 2, N)


def add(p1: Point, p2: Point) -> Point:
    if p1.inf:
        return p2
    if p2.inf:
        return p1
    if p1.x == p2.x:
        if (p1.y + p2.y) % P == 0:
            return ZERO
        return double(p1)
    lam = (p2.y - p1.y) * inv_p(p2.x - p1.x) % P
    x3 = (lam * lam - p1.x - p2.x) % P
    y3 = (lam * (p1.x - x3) - p1.y) % P
    return Point(x3, y3)


def double(p: Point) -> Point:
    if p.inf or p.y == 0:
        return ZERO
    lam = (3 * p.x * p.x + A) * inv_p(2 * p.y) % P
    x3 = (lam * lam - 2 * p.x) % P
    y3 = (lam * (p.x - x3) - p.y) % P
    return Point(x3, y3)


def neg(p: Point) -> Point:
    if p.inf:
        return p
    return Point(p.x, (-p.y) % P)


# ------------------------------------------------------------------
# Projective arithmetic + batch inversion (parity:
# reference src/ecdsa/curve/curve_types.rs:173-218, curve_adds.rs)
#
# Jacobian coordinates (X, Y, Z) with x = X/Z^2, y = Y/Z^3: group ops
# are inversion-free; one batched inversion converts back to affine.
# ------------------------------------------------------------------

PJ_ZERO = (0, 1, 0)                     # point at infinity (Z = 0)


def to_proj(p: Point):
    if p.inf:
        return PJ_ZERO
    return (p.x, p.y, 1)


def pj_double(pt):
    """Jacobian doubling, a = 0 short form (dbl-2009-l): 3M + 5S."""
    X, Y, Z = pt
    if Z == 0 or Y == 0:
        return PJ_ZERO
    A = X * X % P
    B_ = Y * Y % P
    C = B_ * B_ % P
    D = 2 * ((X + B_) * (X + B_) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def pj_add(p1, p2):
    """Jacobian + Jacobian (add-2007-bl style with doubling fallback)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == 0:
        return p2
    if Z2 == 0:
        return p1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return PJ_ZERO
        return pj_double(p1)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % P * H % P
    return (X3, Y3, Z3)


def pj_madd(p1, p2: Point):
    """Jacobian + affine mixed addition (madd-2007-bl: 7M + 4S, the
    reference's hot add in summations, curve_adds.rs:60-118)."""
    if p2.inf:
        return p1
    X1, Y1, Z1 = p1
    if Z1 == 0:
        return to_proj(p2)
    Z1Z1 = Z1 * Z1 % P
    U2 = p2.x * Z1Z1 % P
    S2 = p2.y * Z1 % P * Z1Z1 % P
    if U2 == X1:
        if S2 != Y1:
            return PJ_ZERO
        return pj_double(p1)
    H = (U2 - X1) % P
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    r = 2 * (S2 - Y1) % P
    V = X1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def batch_inverse(xs: list[int], m: int = P) -> list[int]:
    """Montgomery batch inversion: one pow + 3(n-1) muls (parity:
    curve_types.rs:173-189 batch_to_affine's trick).  Zeros map to zero."""
    n = len(xs)
    out = [0] * n
    acc = 1
    prefix = [0] * n
    for i, x in enumerate(xs):
        prefix[i] = acc
        if x:
            acc = acc * x % m
    inv = pow(acc, m - 2, m)
    for i in range(n - 1, -1, -1):
        if xs[i]:
            out[i] = inv * prefix[i] % m
            inv = inv * xs[i] % m
    return out


def batch_to_affine(pts: list) -> list[Point]:
    """[(X, Y, Z)] -> [Point] with ONE field inversion total."""
    zinvs = batch_inverse([z for _, _, z in pts])
    out = []
    for (X, Y, Z), zi in zip(pts, zinvs):
        if Z == 0:
            out.append(ZERO)
        else:
            zi2 = zi * zi % P
            out.append(Point(X * zi2 % P, Y * zi2 % P * zi % P))
    return out


def to_affine(pt) -> Point:
    return batch_to_affine([pt])[0]


def mul(p: Point, k: int) -> Point:
    """Variable-base scalar mul: 4-bit windowed double-and-add in Jacobian
    coordinates (the reference uses Yao windows of the same width,
    curve_multiplication.rs:23-74)."""
    k %= N
    if k == 0 or p.inf:
        return ZERO
    # window table 0..15 * p (affine for mixed adds)
    tbl_pj = [PJ_ZERO, to_proj(p)]
    for i in range(2, 16):
        tbl_pj.append(pj_add(tbl_pj[i - 1], tbl_pj[1]))
    tbl = batch_to_affine(tbl_pj)
    digits = []
    while k:
        digits.append(k & 15)
        k >>= 4
    acc = PJ_ZERO
    for d in reversed(digits):
        for _ in range(4):
            acc = pj_double(acc)
        if d:
            acc = pj_madd(acc, tbl[d])
    return to_affine(acc)


def summation(points: list[Point]) -> Point:
    """Sum of many points; pairwise for small inputs, batch-inversion
    affine rounds past the reference's threshold (curve_summation.rs:29-40:
    pairwise under 70, Montgomery-batch affine above)."""
    pts = [p for p in points if not p.inf]
    if len(pts) < 70:
        acc = PJ_ZERO
        for p in pts:
            acc = pj_madd(acc, p)
        return to_affine(acc)
    # affine pairwise rounds with one batched inversion per round
    while len(pts) > 1:
        half = len(pts) // 2
        a, b = pts[:half], pts[half:2 * half]
        rest = pts[2 * half:]
        denoms, kinds = [], []
        for p1, p2 in zip(a, b):
            if p1.x == p2.x:
                if (p1.y + p2.y) % P == 0:
                    denoms.append(1); kinds.append(0)      # p1 + (-p1) = 0
                else:
                    denoms.append(2 * p1.y % P); kinds.append(2)
            else:
                denoms.append((p2.x - p1.x) % P); kinds.append(1)
        invs = batch_inverse(denoms)
        nxt = []
        for p1, p2, inv, kind in zip(a, b, invs, kinds):
            if kind == 0:
                continue
            if kind == 1:
                lam = (p2.y - p1.y) * inv % P
            else:
                lam = 3 * p1.x * p1.x % P * inv % P
            x3 = (lam * lam - p1.x - p2.x) % P
            nxt.append(Point(x3, (lam * (p1.x - x3) - p1.y) % P))
        pts = nxt + rest
    return pts[0] if pts else ZERO


def msm(points: list[Point], scalars: list[int], w: int = 5) -> Point:
    """Multi-scalar multiplication, w-bit bucket (Pippenger) windows with
    Jacobian accumulation (the reference's parallel Yao-digit MSM,
    curve_msm.rs:104-157, shares the digit-decomposition idea; rayon
    chunking maps to plain loops in this host oracle)."""
    pairs = [(p, s % N) for p, s in zip(points, scalars)
             if not p.inf and s % N]
    if not pairs:
        return ZERO
    if len(pairs) == 1:
        return mul(*pairs[0])
    nbits = 256
    nwin = (nbits + w - 1) // w
    acc = PJ_ZERO
    for win in range(nwin - 1, -1, -1):
        for _ in range(w):
            acc = pj_double(acc)
        buckets = [PJ_ZERO] * (1 << w)
        for p, s in pairs:
            d = (s >> (win * w)) & ((1 << w) - 1)
            if d:
                buckets[d] = pj_madd(buckets[d], p)
        run, total = PJ_ZERO, PJ_ZERO
        for d in range((1 << w) - 1, 0, -1):
            run = pj_add(run, buckets[d])
            total = pj_add(total, run)
        acc = pj_add(acc, total)
    return to_affine(acc)


def glv_endo(p: Point) -> Point:
    """psi(x, y) = (beta*x, y) == lambda * (x, y)."""
    return Point(GLV_BETA * p.x % P, p.y)


def glv_decompose(k: int):
    """k = k1 + lambda*k2 (mod n) with |k1|, |k2| ~ sqrt(n).

    Returns (k1, k1_neg, k2, k2_neg) with k1, k2 the magnitudes and flags
    for the signs, mirroring the reference's decomposition output shape
    (reference src/ecdsa/curve/glv.rs:11-76)."""
    # lattice basis for secp256k1 (standard a1/b1/a2/b2 constants)
    a1 = 0x3086D221A7D46BCDE86C90E49284EB15
    b1 = -0xE4437ED6010E88286F547FA90ABFE4C3
    a2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
    b2 = a1
    c1 = (b2 * k) // N
    c2 = (-b1 * k) // N
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    k1_neg, k2_neg = k1 < 0, k2 < 0
    return abs(k1), k1_neg, abs(k2), k2_neg


def glv_mul(p: Point, k: int) -> Point:
    """GLV scalar mul: decompose k = ±k1 ± lambda*k2 with |k1|,|k2| ~
    sqrt(n), then a Shamir dual-MSM over the two half-length scalars with
    a shared doubling chain (parity: glv.rs:82-100 + curve_msm.rs)."""
    k1, k1n, k2, k2n = glv_decompose(k % N)
    p1 = neg(p) if k1n else p
    p2 = glv_endo(p)
    p2 = neg(p2) if k2n else p2
    # joint 2-bit windows over the ~128-bit half scalars
    tbl_pj = [PJ_ZERO] * 16
    for i in range(1, 4):
        tbl_pj[i] = pj_add(tbl_pj[i - 1], to_proj(p1))
        tbl_pj[4 * i] = pj_add(tbl_pj[4 * (i - 1)], to_proj(p2))
    for i in range(1, 4):
        for j in range(1, 4):
            tbl_pj[4 * i + j] = pj_add(tbl_pj[4 * i], tbl_pj[j])
    tbl = batch_to_affine(tbl_pj)
    nwin = (max(k1.bit_length(), k2.bit_length(), 1) + 1) // 2
    acc = PJ_ZERO
    for win in range(nwin - 1, -1, -1):
        acc = pj_double(pj_double(acc))
        d = ((k1 >> (2 * win)) & 3) | (((k2 >> (2 * win)) & 3) << 2)
        if d:
            acc = pj_madd(acc, tbl[d])
    return to_affine(acc)


# ------------------------------------------------------------------
# ECDSA (parity: reference src/ecdsa/curve/ecdsa.rs)
# ------------------------------------------------------------------

def sign(msg_hash: int, sk: int, k: int) -> tuple[int, int]:
    """Sign with explicit nonce k (caller supplies randomness)."""
    msg_hash %= N
    k %= N
    assert k != 0
    r = mul(G, k).x % N
    assert r != 0, "bad nonce"
    s = inv_n(k) * (msg_hash + r * sk) % N
    assert s != 0, "bad nonce"
    return r, s


def verify(msg_hash: int, sig: tuple[int, int], pk: Point) -> bool:
    r, s = sig
    if not (0 < r < N and 0 < s < N) or not pk.is_valid() or pk.inf:
        return False
    c = inv_n(s)
    u1 = msg_hash * c % N
    u2 = r * c % N
    pt = msm([G, pk], [u1, u2])       # 2-point MSM (ecdsa.rs:42-62)
    if pt.inf:
        return False
    return pt.x % N == r
