"""Goldilocks field F_p, p = 2^64 - 2^32 + 1, on torch tensors.

Counterpart of `plonky2_tpu/field/gl.py`.  Two implementations:

* **Scalar ops** (`*_s` suffix) on Python ints, for the host transcript,
  witness and verifier-sized work.
* **Tensor ops** on `torch.int64` tensors holding the u64 bit pattern of a
  canonical element in [0, p).  torch has no usable uint64 arithmetic on
  the CPU, so every unsigned compare is emulated (`ult`: XOR with 2^63,
  then a signed compare) and every right shift is masked after the shift
  (int64 `>>` is arithmetic).  int64 `+`, `-` and `*` wrap mod 2^64, which
  is exactly the u64 arithmetic the reduction below is written for.

A Python int >= 2^63 never goes through `torch.tensor(int)`: scalars are
mapped into int64 range by `to_i64`, arrays through numpy's uint64 view.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ------------------------------------------------------------------
# Constants
# ------------------------------------------------------------------

P = 0xFFFFFFFF00000001          # 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF            # 2^64 mod p == 2^32 - 1
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF

GENERATOR = 7                   # generator of F_p^* (two-adicity 32)
TWO_ADICITY = 32

DTYPE = torch.int64


def to_i64(x: int) -> int:
    """u64 Python int -> the int64 value with the same bit pattern."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


_SIGN = -(1 << 63)              # XOR with this flips the sign bit
_P_I64 = to_i64(P)
_P_FLIP = to_i64(P ^ (1 << 63))  # p with its top bit flipped, for u64 >= p


# ------------------------------------------------------------------
# Scalar (Python int) ops
# ------------------------------------------------------------------

def add_s(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub_s(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg_s(a: int) -> int:
    return 0 if a == 0 else P - a


def mul_s(a: int, b: int) -> int:
    return (a * b) % P


def inv_s(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in Goldilocks")
    return pow(a, P - 2, P)


def pow_s(a: int, e: int) -> int:
    return pow(a, e, P)


@functools.lru_cache(maxsize=None)
def primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th primitive root of unity (Python int)."""
    if n_log > TWO_ADICITY:
        raise ValueError(f"no 2^{n_log} root of unity (two-adicity {TWO_ADICITY})")
    base = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)  # order 2^32
    for _ in range(TWO_ADICITY - n_log):
        base = (base * base) % P
    return base


# ------------------------------------------------------------------
# numpy <-> tensor
# ------------------------------------------------------------------

def to_u64(x) -> np.ndarray:
    """ints / lists / arrays -> canonical numpy uint64 array."""
    return np.asarray(x, dtype=np.uint64)


def to_tensor(x, device="cpu") -> torch.Tensor:
    """ints / lists / uint64 arrays -> int64 tensor with the u64 bits."""
    arr = np.ascontiguousarray(to_u64(x)).view(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def from_tensor(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (one host transfer)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def full(shape, c: int, device) -> torch.Tensor:
    return torch.full(shape, to_i64(c), dtype=DTYPE, device=device)


def full_like(a: torch.Tensor, c: int) -> torch.Tensor:
    return torch.full_like(a, to_i64(c))


# ------------------------------------------------------------------
# Tensor ops (int64 holding u64) — device path
# ------------------------------------------------------------------

def ult(a, b):
    """Unsigned a < b on int64 tensors holding u64 bits."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _ge_p(s):
    """Unsigned s >= p."""
    return (s ^ _SIGN) >= _P_FLIP


def _canon(s):
    """Map a u64 value < 2p to [0, p)."""
    return torch.where(_ge_p(s), s - _P_I64, s)


def _shr32(x):
    """Logical right shift by 32."""
    return (x >> 32) & MASK32


def add(a, b):
    """(a + b) mod p for canonical inputs (< p)."""
    s = a + b                                     # wraps mod 2^64
    s = s + ult(s, a).to(DTYPE) * EPSILON         # carry: + 2^64 mod p
    return _canon(s)


def sub(a, b):
    d = a - b
    return d - ult(a, b).to(DTYPE) * EPSILON      # borrow: + p (wrapping)


def neg(a):
    return torch.where(a == 0, a, _P_I64 - a)


def _mul_wide(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) u64 pair."""
    a_lo = a & MASK32
    a_hi = _shr32(a)
    b_lo = b & MASK32
    b_hi = _shr32(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    # carry column at 2^32: ll's top half + low halves of the cross terms
    t = _shr32(ll) + (lh & MASK32) + (hl & MASK32)   # <= 3*(2^32-1)
    lo = (ll & MASK32) | ((t & MASK32) << 32)
    hi = hh + _shr32(lh) + _shr32(hl) + _shr32(t)
    return hi, lo


def _reduce128(hi, lo):
    """Reduce hi*2^64 + lo mod p, to canonical form.

    Uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p):
        x = lo - hi_hi + hi_lo * (2^32 - 1).
    """
    hi_hi = _shr32(hi)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = t0 - ult(lo, hi_hi).to(DTYPE) * EPSILON  # borrow: + p
    t1 = hi_lo * EPSILON                          # < 2^64
    s = t0 + t1
    s = s + ult(s, t1).to(DTYPE) * EPSILON        # carry: + 2^64 mod p
    return _canon(s)


def mul(a, b):
    """(a * b) mod p, canonical."""
    hi, lo = _mul_wide(a, b)
    return _reduce128(hi, lo)


def sqr(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a ** e for a Python-int exponent (square-and-multiply)."""
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = sqr(base)
    return result


def _nsqr(x, n: int):
    for _ in range(n):
        x = sqr(x)
    return x


def inv(a):
    """Element-wise inverse via Fermat, a^(p-2), by the addition chain for
    p - 2 = 0xFFFFFFFE_FFFFFFFF (the JAX package's chain)."""
    t2 = mul(sqr(a), a)                     # a^(2^2 - 1)
    t3 = mul(sqr(t2), a)                    # a^(2^3 - 1)
    t6 = mul(_nsqr(t3, 3), t3)              # a^(2^6 - 1)
    t12 = mul(_nsqr(t6, 6), t6)             # a^(2^12 - 1)
    t24 = mul(_nsqr(t12, 12), t12)          # a^(2^24 - 1)
    t30 = mul(_nsqr(t24, 6), t6)            # a^(2^30 - 1)
    t31 = mul(sqr(t30), a)                  # a^(2^31 - 1)
    t63 = _nsqr(t31, 33)                    # a^((2^31-1) * 2^33)
    t32 = mul(sqr(t31), a)                  # a^(2^32 - 1)
    return mul(t63, t32)


def host_powers(base: int, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)] as a numpy uint64 array."""
    out = [1] * n
    cur = 1
    for i in range(1, n):
        cur = (cur * base) % P
        out[i] = cur
    return np.array(out, dtype=np.uint64)


def powers(base: int, n: int, device="cpu") -> torch.Tensor:
    """[1, base, ..., base^(n-1)] as a tensor (host-computed)."""
    return to_tensor(host_powers(base, n), device)


def sum_mod(x, dim: int = 0):
    """Modular sum along a dim by pairwise folding (torch.sum would wrap
    mod 2^64, not mod p)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = add(x[0:2 * half:2], x[1:2 * half:2])
        x = torch.cat([folded, x[2 * half:]], dim=0) if x.shape[0] & 1 else folded
    return x[0]
