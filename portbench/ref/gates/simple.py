"""ConstantGate, PublicInputGate, NoopGate.

Host copies of `plonky2_tpu/gates/simple.py` (plonky2's gates of the same
names).
"""

from __future__ import annotations

from ..witness import LambdaGenerator
from .base import Gate


class ConstantGate(Gate):
    """num_consts routed wires pinned to per-instance gate constants."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def key(self) -> str:
        return f"Constant(num_consts={self.num_consts})"

    @property
    def num_wires(self):
        return self.num_consts

    @property
    def num_constants(self):
        return self.num_consts

    @property
    def degree(self):
        return 1

    @property
    def num_constraints(self):
        return self.num_consts

    def eval(self, vars, alg):
        return [alg.sub(vars.local_constants[i], vars.local_wires[i])
                for i in range(self.num_consts)]

    def generators(self, row, constants):
        from ..ir.builder import Wire
        return [LambdaGenerator(
            [],
            lambda _vals, row=row, constants=tuple(constants): [
                (Wire(row, i), c) for i, c in enumerate(constants)],
            outs=[Wire(row, i) for i in range(len(constants))],
            op=("consts",) + tuple(constants))]


class PublicInputGate(Gate):
    """4 routed wires constrained to equal the public-inputs hash, which the
    verifier recomputes natively (plonky2 semantics: PIs are Poseidon-hashed
    into 4 elements that enter constraint evaluation as public values)."""

    def key(self) -> str:
        return "PublicInput"

    @property
    def num_wires(self):
        return 4

    @property
    def degree(self):
        return 1

    @property
    def num_constraints(self):
        return 4

    def eval(self, vars, alg):
        return [alg.sub(vars.local_wires[i], vars.public_inputs_hash[i])
                for i in range(4)]

    def generators(self, row, constants):
        # The builder wires these from the registered public-input targets;
        # the generator lives in builder.build() because it needs the PI list.
        return []


class NoopGate(Gate):
    def key(self) -> str:
        return "Noop"

    @property
    def num_wires(self):
        return 0

    @property
    def degree(self):
        return 0

    @property
    def num_constraints(self):
        return 0

    def eval(self, vars, alg):
        return []
