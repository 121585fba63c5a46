"""CircuitAlg: evaluate gate constraints inside another circuit.

Host copy of `plonky2_tpu/recursion/circuit_alg.py`: plonky2's
`Gate::eval_unfiltered_circuit` without per-gate code.  Every gate
writes its constraints once against a generic algebra (gates/base.py), so
running `gate.eval(vars, CircuitAlg(builder))` with
extension-target wires emits the identical constraint arithmetic as
ArithmeticExtension/MulExtension gate rows in the outer circuit.
"""

from __future__ import annotations

from ..field import gl


class CircuitAlg:
    """Values are extension targets — (c0, c1) tuples of builder targets."""

    def __init__(self, builder):
        self.b = builder

    def constant(self, c: int):
        return self.b.constant_extension((c % gl.P, 0))

    def add(self, a, b):
        return self.b.add_extension(a, b)

    def sub(self, a, b):
        return self.b.sub_extension(a, b)

    def mul(self, a, b):
        return self.b.mul_extension(a, b)

    def mul_const(self, c: int, a):
        return self.b.scalar_mul_ext(c % gl.P, a)

    def add_const(self, a, c: int):
        # a*1 + c*1 in one ArithmeticExtension slot
        one = self.b.one_extension()
        return self.b.arithmetic_extension(1, c % gl.P, a, one, one)

    @property
    def zero(self):
        return self.constant(0)

    @property
    def one(self):
        return self.constant(1)


def eval_gate_constraints_circuit(builder, gate, wires, constants,
                                  public_inputs_hash=None):
    """Emit `gate`'s constraint evaluations into `builder`.

    wires / constants / public_inputs_hash: extension targets (the openings
    of the wire, constant, and PI-hash polynomials at zeta in the recursive
    verifier).  Returns the list of constraint-value extension targets.
    """
    from ..gates.base import EvalVars
    alg = CircuitAlg(builder)
    if public_inputs_hash is None:
        public_inputs_hash = [alg.zero] * 4
    vars_ = EvalVars(list(wires), list(constants), list(public_inputs_hash))
    return gate.eval(vars_, alg)
