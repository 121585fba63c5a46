"""ArithmeticGate: num_ops slots of `const_0 * m0 * m1 + const_1 * addend`.

Host copy of `plonky2_tpu/gates/arithmetic.py` (plonky2's ArithmeticGate).
Each op uses 4 routed wires (m0, m1, addend, out); the two constants are
per-row, so the builder packs ops with matching constants into shared rows
(plonky2's `find_slot`).
"""

from __future__ import annotations

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate


class ArithmeticGate(Gate):
    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config) -> "ArithmeticGate":
        return ArithmeticGate(config.num_routed_wires // 4)

    def key(self) -> str:
        return f"Arithmetic(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return 4 * self.num_ops

    @property
    def num_constants(self):
        return 2

    @property
    def degree(self):
        return 3

    @property
    def num_constraints(self):
        return self.num_ops

    @staticmethod
    def wires_op(i: int):
        return (4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3)  # m0, m1, addend, out

    def eval(self, vars, alg):
        c0, c1 = vars.local_constants[0], vars.local_constants[1]
        out = []
        for i in range(self.num_ops):
            m0, m1, ad, o = (vars.local_wires[w] for w in self.wires_op(i))
            computed = alg.add(alg.mul(c0, alg.mul(m0, m1)), alg.mul(c1, ad))
            out.append(alg.sub(computed, o))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        c0, c1 = constants[0], constants[1]
        gens = []
        for i in range(self.num_ops):
            w0, w1, w2, w3 = self.wires_op(i)
            gens.append(LambdaGenerator(
                [Wire(row, w0), Wire(row, w1), Wire(row, w2)],
                lambda vals, row=row, w3=w3, c0=c0, c1=c1: [
                    (Wire(row, w3),
                     (c0 * vals[0] * vals[1] + c1 * vals[2]) % gl.P)],
                outs=[Wire(row, w3)], op=("arith", c0, c1)))
        return gens
