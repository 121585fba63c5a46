"""zkDSA accounts: toy Poseidon keypairs and 1-element addresses.

Host copy of `plonky2_tpu/zkdsa/account.py`: `Address` (one field
element, 0x-prefixed big-endian u64 hex), `public_key =
Poseidon_two_to_one(sk, sk)`, `address = pk[0]`, and `Account`.  Malformed
input raises ValueError.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl
from ..hashes import poseidon
from ..smt.hash_out import HashOut, ZERO_HASH

SecretKey = HashOut
PublicKey = HashOut


@dataclass(frozen=True)
class Address:
    value: int          # one Goldilocks element

    def to_hex(self) -> str:
        """0x-prefixed big-endian hex of the canonical u64."""
        return "0x" + int(self.value).to_bytes(8, "big").hex()

    @classmethod
    def from_hex(cls, s: str) -> "Address":
        if not s.startswith("0x"):
            raise ValueError(f"missing 0x prefix: {s}")
        raw = bytes.fromhex(s[2:].zfill(16) if len(s) - 2 < 16 else s[2:])
        if len(raw) > 8:
            raise ValueError("too long hexadecimal sequence")
        v = int.from_bytes(raw, "big")
        if v >= gl.P:
            raise ValueError(f"{s} is not a field element")
        return cls(v)

    def to_hash_out(self) -> HashOut:
        return (self.value, 0, 0, 0)

    @classmethod
    def from_hash_out(cls, h: HashOut) -> "Address":
        if h[1] != 0 or h[2] != 0 or h[3] != 0:
            raise ValueError(f"an address's hash has zero limbs 1-3, got {h}")
        return cls(h[0])

    @classmethod
    def read(cls, it) -> "Address":
        v = next(it)
        for _ in range(3):
            next(it)
        return cls(v)

    def write(self, out: list) -> None:
        out.append(self.value)
        out.extend([0, 0, 0])

    def __str__(self) -> str:
        return self.to_hex()


def private_key_to_public_key(private_key: SecretKey) -> PublicKey:
    return tuple(poseidon.two_to_one_s(list(private_key),
                                       list(private_key)))


def public_key_to_address(public_key: PublicKey) -> Address:
    return Address(public_key[0])


@dataclass(frozen=True)
class Account:
    private_key: SecretKey
    public_key: PublicKey
    address: Address

    @classmethod
    def new(cls, private_key: SecretKey) -> "Account":
        return private_key_to_account(private_key)


def private_key_to_account(private_key: SecretKey) -> Account:
    public_key = private_key_to_public_key(private_key)
    return Account(private_key, public_key,
                   public_key_to_address(public_key))


def sign_message(private_key: SecretKey, message: HashOut) -> HashOut:
    """signature = Poseidon_two_to_one(sk, msg) (the toy scheme the
    SimpleSignature circuit proves)."""
    return tuple(poseidon.two_to_one_s(list(private_key), list(message)))
