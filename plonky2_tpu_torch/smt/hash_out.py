"""HashOut values for the SMT: 4 Goldilocks elements and their bits.

Host copy of `plonky2_tpu/smt/hash_out.py` (the reference's
`WrappedHashOut` u32/u64/u128 packing and `KeyLike::to_bits`: little-endian
bits of the 32-byte LE encoding).  The hex and byte serde of the JAX module
have no caller and are not carried over.
"""

from __future__ import annotations

HashOut = tuple          # (e0, e1, e2, e3) Python ints < p
ZERO_HASH: HashOut = (0, 0, 0, 0)


def hash_from_u32(x: int) -> HashOut:
    if not 0 <= x < (1 << 32):
        raise ValueError(f"{x} is not a u32")
    return (x, 0, 0, 0)


def hash_from_u64(x: int) -> HashOut:
    # split into u32 halves so that every element is canonical
    return (x & 0xFFFFFFFF, x >> 32, 0, 0)


def hash_from_u128(x: int) -> HashOut:
    return (x & 0xFFFFFFFF, (x >> 32) & 0xFFFFFFFF,
            (x >> 64) & 0xFFFFFFFF, (x >> 96) & 0xFFFFFFFF)


def key_to_bits(key: HashOut, n_bits: int = 256) -> list[bool]:
    """LE bits of the 32-byte encoding: bit i = bit (i%64) of element i//64."""
    return [bool((key[i // 64] >> (i % 64)) & 1) for i in range(n_bits)]
