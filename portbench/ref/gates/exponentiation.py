"""ExponentiationGate: base^exponent with a square-and-multiply chain.

Host copy of `plonky2_tpu/gates/exponentiation.py` (plonky2's
`ExponentiationGate`, placed by `CircuitBuilder.exp_from_bits`).  The
exponent arrives as `num_power_bits` routed bit wires (an MSB-first chain
over LSB-first wires, as in plonky2); one intermediate wire per step keeps
every constraint at degree 4: `acc_i == acc_{i-1}^2 * (bit * base + (1 -
bit))`.  Its generator has no op spec, so the witness tape runs it as a
Python escape, as the JAX tape does.
"""

from __future__ import annotations

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate


class ExponentiationGate(Gate):
    def __init__(self, num_power_bits: int):
        if num_power_bits < 1:
            raise ValueError(
                f"ExponentiationGate needs num_power_bits >= 1, got {num_power_bits}")
        self.num_power_bits = num_power_bits

    @staticmethod
    def from_config(config) -> "ExponentiationGate":
        # routed: base + bits + output; aux: num_power_bits intermediates
        return ExponentiationGate(
            min(config.num_routed_wires - 2,
                config.num_wires - config.num_routed_wires))

    def key(self) -> str:
        return f"Exponentiation(num_power_bits={self.num_power_bits})"

    WIRE_BASE = 0

    def wire_bit(self, i: int) -> int:
        """i-th exponent bit, little-endian."""
        return 1 + i

    @property
    def wire_output(self) -> int:
        return 1 + self.num_power_bits

    def wire_intermediate(self, j: int) -> int:
        return 2 + self.num_power_bits + j

    @property
    def num_wires(self):
        return 2 + 2 * self.num_power_bits

    @property
    def degree(self):
        return 4

    @property
    def num_constraints(self):
        return 2 * self.num_power_bits + 1

    def eval(self, vars, alg):
        w = vars.local_wires
        base = w[self.WIRE_BASE]
        nb = self.num_power_bits
        out = []
        prev = alg.one
        for j in range(nb):
            bit = w[self.wire_bit(nb - 1 - j)]          # MSB-first
            out.append(alg.mul(bit, alg.add_const(bit, gl.P - 1)))
            cur = w[self.wire_intermediate(j)]
            mult = alg.add(alg.mul(bit, base),
                           alg.sub(alg.one, bit))
            out.append(alg.sub(cur, alg.mul(alg.mul(prev, prev), mult)))
            prev = cur
        out.append(alg.sub(w[self.wire_output],
                           w[self.wire_intermediate(nb - 1)]))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        nb = self.num_power_bits

        def fn(vals, row=row):
            base, bits = vals[0], vals[1:]
            acc = 1
            out = []
            for j in range(nb):
                bit = bits[nb - 1 - j]
                acc = (acc * acc * (base if bit else 1)) % gl.P
                out.append((Wire(row, self.wire_intermediate(j)), acc))
            out.append((Wire(row, self.wire_output), acc))
            return out

        return [LambdaGenerator(
            [Wire(row, self.WIRE_BASE)] +
            [Wire(row, self.wire_bit(i)) for i in range(nb)], fn,
            outs=[Wire(row, self.wire_intermediate(j)) for j in range(nb)] +
                 [Wire(row, self.wire_output)])]
