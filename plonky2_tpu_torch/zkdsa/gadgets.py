"""zkDSA circuit gadgets: SimpleSignature + Address targets.

Host copy of `plonky2_tpu/zkdsa/gadgets.py`: `SimpleSignatureTarget` and
`verify_simple_signature` (pk = H(sk, sk), sig = H(sk, msg)), and
`AddressTarget` (elements 1..3 constrained to zero).
"""

from __future__ import annotations

from ..gadgets.smt import add_virtual_hash, set_hash_witness
from ..ir.builder import CircuitBuilder


def verify_simple_signature(b: CircuitBuilder, private_key, message):
    """Returns (signature, public_key)."""
    public_key = b.two_to_one(private_key, private_key)
    signature = b.two_to_one(private_key, message)
    return signature, public_key


class SimpleSignatureTarget:
    def __init__(self, private_key, public_key, message, signature):
        self.private_key = private_key
        self.public_key = public_key
        self.message = message
        self.signature = signature

    @classmethod
    def add_virtual_to(cls, b: CircuitBuilder) -> "SimpleSignatureTarget":
        private_key = add_virtual_hash(b)
        message = add_virtual_hash(b)
        signature, public_key = verify_simple_signature(b, private_key,
                                                        message)
        return cls(private_key, public_key, message, signature)

    def set_witness(self, pw: dict, private_key, message) -> None:
        set_hash_witness(pw, self.private_key, private_key)
        set_hash_witness(pw, self.message, message)


class AddressTarget:
    def __init__(self, elements):
        self.elements = elements

    @classmethod
    def add_virtual_to(cls, b: CircuitBuilder) -> "AddressTarget":
        t = add_virtual_hash(b)
        zero = b.zero()
        for e in t[1:]:
            b.connect(e, zero)
        return cls(t)

    def set_witness(self, pw: dict, address) -> None:
        set_hash_witness(pw, self.elements, address.to_hash_out())
