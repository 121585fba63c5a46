"""Gate base: wire layout + constraints written once against a generic
algebra.

Counterpart of `plonky2_tpu/gates/base.py`.  `Gate.eval(vars, alg)` is
written against a generic algebra; `BatchAlg` evaluates it on int64
tensors over a domain chunk (the prover's quotient), `ExtAlg` on GF(p^2)
scalars (the verifier's check at zeta).  Gate instances sit one per row;
constraints are multiplied by the selector-derived filter outside the
gate.
"""

from __future__ import annotations

from ..field import ext, gl


class BatchAlg:
    """Base-field batch algebra: values are int64 tensors of one shape."""

    def __init__(self, shape, device):
        self.shape = tuple(shape)
        self.device = device

    def constant(self, c: int):
        return gl.full(self.shape, c, self.device)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_const(self, c: int, a):
        return gl.mul(self.constant(c), a)

    def add_const(self, a, c: int):
        return gl.add(a, self.constant(c))

    @property
    def zero(self):
        return self.constant(0)

    @property
    def one(self):
        return self.constant(1)


class ExtAlg:
    """Extension-scalar algebra: values are (c0, c1) Python-int tuples."""

    def constant(self, c: int):
        return ext.from_base_s(c)

    def add(self, a, b):
        return ext.add_s(a, b)

    def sub(self, a, b):
        return ext.sub_s(a, b)

    def mul(self, a, b):
        return ext.mul_s(a, b)

    def mul_const(self, c: int, a):
        return ext.scalar_mul_s(a, c)

    def add_const(self, a, c: int):
        return ext.add_s(a, ext.from_base_s(c))

    @property
    def zero(self):
        return ext.ZERO

    @property
    def one(self):
        return ext.ONE


class EvalVars:
    """What a gate sees on its row: wires, per-gate constants, PI hash."""

    def __init__(self, local_wires, local_constants, public_inputs_hash):
        self.local_wires = local_wires
        self.local_constants = local_constants
        self.public_inputs_hash = public_inputs_hash


class Gate:
    """Abstract gate type.  Stateless; parameters go in the constructor and
    must be reflected in `key` (used for slot packing + selector grouping)."""

    def key(self) -> str:
        raise NotImplementedError

    @property
    def num_wires(self) -> int:
        raise NotImplementedError

    @property
    def num_constants(self) -> int:
        return 0

    @property
    def degree(self) -> int:
        raise NotImplementedError

    @property
    def num_constraints(self) -> int:
        raise NotImplementedError

    def eval(self, vars: EvalVars, alg) -> list:
        """Return the list of constraint values (must vanish on valid rows)."""
        raise NotImplementedError

    def generators(self, row: int, constants: list[int]) -> list:
        """Witness generators for one instance placed at `row`."""
        return []
