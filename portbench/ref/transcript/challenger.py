"""Fiat-Shamir challenger: a duplex sponge over Goldilocks.

Host copy of `plonky2_tpu/transcript/challenger.py` (plonky2's
`Challenger` semantics):

* `observe_element` buffers field elements; when RATE=8 are pending they are
  absorbed by *overwriting* state[0..8] and permuting.
* `get_challenge` absorbs any pending partial buffer (same overwrite rule),
  refills the output buffer with state[0..8], and pops challenges from the
  *end* of that buffer (Vec::pop order).
* Extension elements are observed/drawn as their 2 base coefficients;
  Merkle caps as the flattened digest elements.

The sponge is the config's transcript hasher, `hashes.poseidon` or
`hashes.keccak_hash` (KeccakGoldilocksConfig), which every caller passes
(`CircuitConfig.transcript_module()`); both modules have the same
surface (`permute_s`, WIDTH, RATE, HASH_OUT).

The FRI proof-of-work grind (`fri.grind`) evaluates the "observe(w);
get_challenge()" transition for many w at once and depends on this rule.
"""

from __future__ import annotations


class Challenger:
    def __init__(self, hasher):
        self.hasher = hasher
        self.sponge_state = [0] * hasher.WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # ---------------- observing ----------------

    def observe_element(self, x: int):
        self.output_buffer.clear()          # pending inputs invalidate outputs
        self.input_buffer.append(x)
        if len(self.input_buffer) == self.hasher.RATE:
            self._duplex()

    def observe_elements(self, xs):
        for x in xs:
            self.observe_element(int(x))

    def observe_ext(self, x):
        self.observe_elements(x)

    def observe_hash(self, h):
        if len(h) != self.hasher.HASH_OUT:
            raise ValueError(f"digest has {len(h)} elements")
        self.observe_elements(h)

    def observe_cap(self, cap):
        for h in cap:
            self.observe_hash(list(h))

    # ---------------- duplexing ----------------

    def _duplex(self):
        buf = self.input_buffer
        self.sponge_state[: len(buf)] = buf
        self.sponge_state = self.hasher.permute_s(self.sponge_state)
        self.output_buffer = self.sponge_state[: self.hasher.RATE].copy()
        self.input_buffer = []

    # ---------------- challenges ----------------

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self) -> tuple[int, int]:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return (c0, c1)

    def clone(self) -> "Challenger":
        c = Challenger(self.hasher)
        c.sponge_state = self.sponge_state.copy()
        c.input_buffer = self.input_buffer.copy()
        c.output_buffer = self.output_buffer.copy()
        return c
