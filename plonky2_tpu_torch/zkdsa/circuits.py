"""Typed SimpleSignature circuit wrapper.

Host copy of `plonky2_tpu/zkdsa/circuits.py`: the inner circuit of config
5.  `make_simple_signature_circuit` registers 12 public inputs in
message, public_key, signature order; `SimpleSignaturePublicInputs`
encodes and decodes them; `SimpleSignatureCircuit.prove/verify` are the
typed entry points.  The circuit's tensors live on `device`: the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hashes import poseidon
from ..ir import CircuitBuilder, CircuitConfig
from ..smt.hash_out import HashOut, ZERO_HASH
from ..utils.device import DEFAULT_DEVICE
from .gadgets import SimpleSignatureTarget


@dataclass
class SimpleSignaturePublicInputs:
    message: HashOut
    public_key: HashOut
    signature: HashOut

    @classmethod
    def default(cls) -> "SimpleSignaturePublicInputs":
        pk = tuple(poseidon.two_to_one_s(list(ZERO_HASH), list(ZERO_HASH)))
        sig = pk  # H(0, 0) == H(0, default message 0)
        return cls(ZERO_HASH, pk, sig)

    def encode(self) -> list[int]:
        out = list(self.message) + list(self.public_key) + list(self.signature)
        if len(out) != 12:
            raise ValueError(f"{len(out)} public inputs, expected 12")
        return out

    @classmethod
    def decode(cls, public_inputs) -> "SimpleSignaturePublicInputs":
        if len(public_inputs) != 12:
            raise ValueError(f"{len(public_inputs)} public inputs, expected 12")
        return cls(tuple(public_inputs[0:4]), tuple(public_inputs[4:8]),
                   tuple(public_inputs[8:12]))


@dataclass
class SimpleSignatureProof:
    proof: object            # prover Proof object
    public_inputs: SimpleSignaturePublicInputs


class SimpleSignatureCircuit:
    def __init__(self, data, targets: SimpleSignatureTarget):
        self.data = data
        self.targets = targets

    def prove(self, private_key: HashOut,
              message: HashOut) -> SimpleSignatureProof:
        pw: dict = {}
        self.targets.set_witness(pw, private_key, message)
        proof = self.data.prove(pw)
        return SimpleSignatureProof(
            proof, SimpleSignaturePublicInputs.decode(proof.public_inputs))

    def verify(self, proof: SimpleSignatureProof) -> None:
        if list(proof.proof.public_inputs) != proof.public_inputs.encode():
            raise ValueError("the proof's public inputs differ from its typed ones")
        self.data.verify(proof.proof)


def make_simple_signature_circuit(config=None, device=DEFAULT_DEVICE
                                  ) -> SimpleSignatureCircuit:
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    targets = SimpleSignatureTarget.add_virtual_to(builder)
    builder.register_public_inputs(targets.message)      # [0..4]
    builder.register_public_inputs(targets.public_key)   # [4..8]
    builder.register_public_inputs(targets.signature)    # [8..12]
    data = builder.build(device=device)
    return SimpleSignatureCircuit(data, targets)


def prove_simple_signature(private_key: HashOut, message: HashOut,
                           config=None, device=DEFAULT_DEVICE
                           ) -> SimpleSignatureProof:
    circuit = make_simple_signature_circuit(config, device)
    proof = circuit.prove(private_key, message)
    circuit.verify(proof)
    return proof
