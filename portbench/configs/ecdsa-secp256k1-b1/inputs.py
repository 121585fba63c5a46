"""The input maker of `ecdsa-secp256k1-b1`: a fresh secp256k1 key, message
hash and signature for every statement, from the benchmark's plain-int
signer (`portbench/ref/field/secp.py`).

`make(rng, sizes)` -> the circuit's input values in the order of its input
targets: per signature the message hash, r, s and the key's x and y, each
as eight little-endian 32-bit limbs.
"""

from __future__ import annotations

from portbench.ref.field import secp

LIMBS = 8


def limbs(value: int) -> list[int]:
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(LIMBS)]


def signature(rng):
    """(h, (r, s), public key) of a fresh key, message hash and nonce."""
    sk = rng.randrange(1, secp.N)
    h = rng.randrange(secp.N)
    while True:
        k = rng.randrange(1, secp.N)
        r = secp.mul(secp.G, k).x % secp.N
        s = secp.inv_n(k) * (h + r * sk) % secp.N
        if r and s:
            return h, (r, s), secp.mul(secp.G, sk)


def make(rng, sizes: dict) -> list[int]:
    per_sig = 5 * LIMBS
    if sizes["input_values"] % per_sig:
        raise ValueError(f"{sizes['input_values']} input values are not whole signatures")
    values = []
    for _ in range(sizes["input_values"] // per_sig):
        h, (r, s), pk = signature(rng)
        for v in (h, r, s, pk.x, pk.y):
            values += limbs(v)
    return values
