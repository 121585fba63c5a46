"""RecursiveChallenger: the Fiat-Shamir transcript replayed in-circuit.

Host copy of `plonky2_tpu/recursion/challenger.py`: a target-level mirror
of transcript/challenger.py (plonky2's `RecursiveChallenger`).  A
circuit's observation sequence is static, so the sponge schedule here
matches the host challenger permutation for permutation, and an in-circuit
verifier derives the *same* challenges the prover drew.
"""

from __future__ import annotations

from ..hashes import poseidon


class RecursiveChallenger:
    def __init__(self, builder):
        self.b = builder
        self.sponge_state = [builder.zero()] * poseidon.WIDTH
        self.input_buffer: list = []
        self.output_buffer: list = []

    # ---------------- observing ----------------

    def observe_element(self, t):
        self.output_buffer.clear()
        self.input_buffer.append(t)
        if len(self.input_buffer) == poseidon.RATE:
            self._duplex()

    def observe_elements(self, ts):
        for t in ts:
            self.observe_element(t)

    def observe_ext(self, t):
        self.observe_elements(t)

    def observe_hash(self, h):
        if len(h) != poseidon.HASH_OUT:
            raise ValueError(f"digest has {len(h)} elements")
        self.observe_elements(h)

    def observe_cap(self, cap):
        for h in cap:
            self.observe_hash(list(h))

    # ---------------- duplexing ----------------

    def _duplex(self):
        state = list(self.sponge_state)
        state[: len(self.input_buffer)] = self.input_buffer
        self.sponge_state = self.b.permute(state)
        self.output_buffer = self.sponge_state[: poseidon.RATE].copy()
        self.input_buffer = []

    # ---------------- challenges ----------------

    def get_challenge(self):
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list:
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self):
        return (self.get_challenge(), self.get_challenge())
