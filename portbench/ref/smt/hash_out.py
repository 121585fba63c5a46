"""HashOut values for the SMT: 4 Goldilocks elements and their bits.

Host copy of `plonky2_tpu/smt/hash_out.py`: the reference's
`WrappedHashOut` (u32/u64/u128 packing, its 32-byte little-endian form and
its 0x-prefixed hex serde form) and `KeyLike::to_bits` (little-endian bits
of the 32-byte LE encoding).
"""

from __future__ import annotations

from ..field.gl import P

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


def to_bytes_le(h: HashOut) -> bytes:
    return b"".join(int(e).to_bytes(8, "little") for e in h)


def from_bytes_le(b: bytes) -> HashOut:
    if len(b) != 32:
        raise ValueError(f"a HashOut is 32 bytes, not {len(b)}")
    out = tuple(int.from_bytes(b[8 * i:8 * i + 8], "little") for i in range(4))
    if not all(e < P for e in out):
        raise ValueError(f"{out} has an element that is not below p")
    return out


def to_hex(h: HashOut) -> str:
    """0x-prefixed big-endian hex (the reference's serde form)."""
    return "0x" + to_bytes_le(h)[::-1].hex()


def from_hex(s: str) -> HashOut:
    if not s.startswith("0x"):
        raise ValueError(f"{s!r} does not start with 0x")
    return from_bytes_le(bytes.fromhex(s[2:].zfill(64))[::-1])


def key_to_bits(key: HashOut, n_bits: int = 256) -> list[bool]:
    """LE bits of the 32-byte encoding: bit i = bit (i%64) of element i//64."""
    return [bool((key[i // 64] >> (i % 64)) & 1) for i in range(n_bits)]
