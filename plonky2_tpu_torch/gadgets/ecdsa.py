"""In-circuit ECDSA signature verification over secp256k1.

Host copy of `plonky2_tpu/gadgets/ecdsa.py` (the reference's
`ecdsa/gadgets/ecdsa.rs`): the signature and public-key targets,
`verify_message_circuit` (the key is on the curve, c = s^-1, u1 = m c,
u2 = r c, P = u1 G (fixed base) + u2 pk (GLV), r == P.x) and
`batch_verify_message_circuit`.

The functions taking `self` are attached to `CircuitBuilder` as methods at
import.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import secp
from . import attach
from .curve import AffinePointTarget
from .nonnative import NonNativeTarget


@dataclass
class ECDSASignatureTarget:
    r: NonNativeTarget      # mod N
    s: NonNativeTarget      # mod N


@dataclass
class ECDSAPublicKeyTarget:
    point: AffinePointTarget


def add_virtual_ecdsa_signature_target(self) -> ECDSASignatureTarget:
    return ECDSASignatureTarget(self.add_virtual_nonnative_target(secp.N),
                                self.add_virtual_nonnative_target(secp.N))


def verify_message_circuit(self, msg: NonNativeTarget,
                           sig: ECDSASignatureTarget,
                           pk: ECDSAPublicKeyTarget) -> None:
    """(ecdsa.rs:138-161)."""
    assert msg.modulus == secp.N
    self.curve_assert_valid(pk.point)
    c = self.inv_nonnative(sig.s)
    u1 = self.mul_nonnative(msg, c)
    u2 = self.mul_nonnative(sig.r, c)
    point1 = self.fixed_base_curve_mul(secp.G, u1)
    point2 = self.glv_mul(pk.point, u2)
    point = self.curve_add(point1, point2)
    # r == point.x as limb values (same simplification as the reference:
    # ignores the negligible r >= |x mod N| wraparound edge)
    x_as_scalar = NonNativeTarget(point.x.value, secp.N)
    self.connect_nonnative(sig.r, x_as_scalar)


def batch_verify_message_circuit(self, msgs: list, sigs: list, pks: list) -> None:
    """(ecdsa.rs:163-191)."""
    for m, s, p in zip(msgs, sigs, pks):
        self.verify_message_circuit(m, s, p)


# ------------------------------------------------------------------
# attach to CircuitBuilder
# ------------------------------------------------------------------

attach(globals())
