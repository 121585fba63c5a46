"""Extension-field arithmetic gates: ArithmeticExtensionGate,
MulExtensionGate, ReducingGate, ReducingExtensionGate.

Host copy of `plonky2_tpu/gates/extension.py` (plonky2's gates of the same
names; the recursive verifier emits its arithmetic as rows of them).  A
GF(p^2) element is two consecutive routed wires (c0, c1) with X^2 = W = 7
(field/ext.py); every extension product is expanded into base-field
constraints, so one generic-algebra `eval` serves the prover's quotient
(`BatchAlg`), the verifier (`ExtAlg`) and the in-circuit verifier
(`recursion.CircuitAlg`).  There is no batch form: the quotient runs the
generic `eval`, as the JAX package does.  Each generator carries its op
spec (`arith_ext`, `mul_ext`, `reduce`, `reduce_ext`), which the witness
tape lowers to the native opcode of that name.
"""

from __future__ import annotations

from ..field import ext
from ..witness import LambdaGenerator
from .base import Gate

D = 2  # extension degree


def _ext_mul(alg, a, b):
    """(a0,a1)*(b0,b1) over GF(p^2), operands/result = pairs of alg values."""
    c0 = alg.add(alg.mul(a[0], b[0]), alg.mul_const(ext.W, alg.mul(a[1], b[1])))
    c1 = alg.add(alg.mul(a[0], b[1]), alg.mul(a[1], b[0]))
    return (c0, c1)


def _ext_add(alg, a, b):
    return (alg.add(a[0], b[0]), alg.add(a[1], b[1]))


def _ext_scalar_mul(alg, s, a):
    return (alg.mul(s, a[0]), alg.mul(s, a[1]))


class ArithmeticExtensionGate(Gate):
    """num_ops slots of `const_0 * m0 * m1 + const_1 * addend` over GF(p^2).

    Layout per op: m0, m1, addend, out — 4 extension operands = 8 routed
    wires.  Constants are base-field and per-row (slot packing groups ops
    with matching constants, like the base ArithmeticGate).
    """

    WIRES_PER_OP = 4 * D

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config) -> "ArithmeticExtensionGate":
        return ArithmeticExtensionGate(
            max(1, config.num_routed_wires // ArithmeticExtensionGate.WIRES_PER_OP))

    def key(self) -> str:
        return f"ArithmeticExtension(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return self.WIRES_PER_OP * self.num_ops

    @property
    def num_constants(self):
        return 2

    @property
    def degree(self):
        return 3

    @property
    def num_constraints(self):
        return D * self.num_ops

    def wires_op(self, i: int):
        b = self.WIRES_PER_OP * i
        return dict(m0=b, m1=b + D, addend=b + 2 * D, out=b + 3 * D)

    def eval(self, vars, alg):
        c0, c1 = vars.local_constants[0], vars.local_constants[1]
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            m0 = (w[ws["m0"]], w[ws["m0"] + 1])
            m1 = (w[ws["m1"]], w[ws["m1"] + 1])
            ad = (w[ws["addend"]], w[ws["addend"] + 1])
            o = (w[ws["out"]], w[ws["out"] + 1])
            prod = _ext_mul(alg, m0, m1)
            computed = _ext_add(alg, _ext_scalar_mul(alg, c0, prod),
                                _ext_scalar_mul(alg, c1, ad))
            out.append(alg.sub(computed[0], o[0]))
            out.append(alg.sub(computed[1], o[1]))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        c0, c1 = constants[0], constants[1]
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws, c0=c0, c1=c1):
                m0, m1, ad = vals[0:2], vals[2:4], vals[4:6]
                r = ext.add_s(
                    ext.scalar_mul_s(ext.mul_s(tuple(m0), tuple(m1)), c0),
                    ext.scalar_mul_s(tuple(ad), c1))
                return [(Wire(row, ws["out"]), r[0]),
                        (Wire(row, ws["out"] + 1), r[1])]

            gens.append(LambdaGenerator(
                [Wire(row, ws["m0"]), Wire(row, ws["m0"] + 1),
                 Wire(row, ws["m1"]), Wire(row, ws["m1"] + 1),
                 Wire(row, ws["addend"]), Wire(row, ws["addend"] + 1)], fn,
                outs=[Wire(row, ws["out"]), Wire(row, ws["out"] + 1)],
                op=("arith_ext", c0, c1)))
        return gens


class MulExtensionGate(Gate):
    """num_ops slots of `const_0 * m0 * m1` over GF(p^2) (3 ext operands)."""

    WIRES_PER_OP = 3 * D

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config) -> "MulExtensionGate":
        return MulExtensionGate(
            max(1, config.num_routed_wires // MulExtensionGate.WIRES_PER_OP))

    def key(self) -> str:
        return f"MulExtension(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return self.WIRES_PER_OP * self.num_ops

    @property
    def num_constants(self):
        return 1

    @property
    def degree(self):
        return 3

    @property
    def num_constraints(self):
        return D * self.num_ops

    def wires_op(self, i: int):
        b = self.WIRES_PER_OP * i
        return dict(m0=b, m1=b + D, out=b + 2 * D)

    def eval(self, vars, alg):
        c0 = vars.local_constants[0]
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            m0 = (w[ws["m0"]], w[ws["m0"] + 1])
            m1 = (w[ws["m1"]], w[ws["m1"] + 1])
            o = (w[ws["out"]], w[ws["out"] + 1])
            computed = _ext_scalar_mul(alg, c0, _ext_mul(alg, m0, m1))
            out.append(alg.sub(computed[0], o[0]))
            out.append(alg.sub(computed[1], o[1]))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        c0 = constants[0]
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws, c0=c0):
                r = ext.scalar_mul_s(
                    ext.mul_s(tuple(vals[0:2]), tuple(vals[2:4])), c0)
                return [(Wire(row, ws["out"]), r[0]),
                        (Wire(row, ws["out"] + 1), r[1])]

            gens.append(LambdaGenerator(
                [Wire(row, ws["m0"]), Wire(row, ws["m0"] + 1),
                 Wire(row, ws["m1"]), Wire(row, ws["m1"] + 1)], fn,
                outs=[Wire(row, ws["out"]), Wire(row, ws["out"] + 1)],
                op=("mul_ext", c0)))
        return gens


class ReducingGate(Gate):
    """Horner fold of `num_coeffs` *base-field* coefficients into an
    extension accumulator: acc_i = acc_{i-1} * alpha + coeff_i.

    Routed: output (D), alpha (D), old_acc (D), coeffs (num_coeffs).
    Aux: intermediate accumulators, D*(num_coeffs-1).  One constraint pair
    per step; degree 2 (only alpha*acc products).
    """

    def __init__(self, num_coeffs: int):
        if num_coeffs < 1:
            raise ValueError(f"ReducingGate needs num_coeffs >= 1, got {num_coeffs}")
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs(config) -> int:
        routed = config.num_routed_wires - 3 * D
        aux_room = (config.num_wires - 3 * D + D) // (1 + D)
        return max(1, min(routed, aux_room))

    def key(self) -> str:
        return f"Reducing(num_coeffs={self.num_coeffs})"

    WIRE_OUTPUT = 0          # D wires
    WIRE_ALPHA = D           # D wires
    WIRE_OLD_ACC = 2 * D     # D wires
    WIRE_COEFFS = 3 * D      # num_coeffs wires

    @property
    def wire_accs(self):
        return 3 * D + self.num_coeffs  # D*(num_coeffs-1) aux wires

    @property
    def num_routed(self):
        return 3 * D + self.num_coeffs

    @property
    def num_wires(self):
        return self.num_routed + D * (self.num_coeffs - 1)

    @property
    def degree(self):
        return 2

    @property
    def num_constraints(self):
        return D * self.num_coeffs

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        acc = (w[self.WIRE_OLD_ACC], w[self.WIRE_OLD_ACC + 1])
        alpha = (w[self.WIRE_ALPHA], w[self.WIRE_ALPHA + 1])
        for i in range(self.num_coeffs):
            if i < self.num_coeffs - 1:
                nxt = (w[self.wire_accs + D * i], w[self.wire_accs + D * i + 1])
            else:
                nxt = (w[self.WIRE_OUTPUT], w[self.WIRE_OUTPUT + 1])
            prod = _ext_mul(alg, acc, alpha)
            out.append(alg.sub(alg.add(prod[0], w[self.WIRE_COEFFS + i]),
                               nxt[0]))
            out.append(alg.sub(prod[1], nxt[1]))
            acc = nxt
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire

        def fn(vals, row=row):
            alpha = tuple(vals[0:2])
            acc = tuple(vals[2:4])
            coeffs = vals[4:]
            out = []
            for i, c in enumerate(coeffs):
                acc = ext.add_s(ext.mul_s(acc, alpha), ext.from_base_s(c))
                if i < self.num_coeffs - 1:
                    out.append((Wire(row, self.wire_accs + D * i), acc[0]))
                    out.append((Wire(row, self.wire_accs + D * i + 1), acc[1]))
            out.append((Wire(row, self.WIRE_OUTPUT), acc[0]))
            out.append((Wire(row, self.WIRE_OUTPUT + 1), acc[1]))
            return out

        deps = [Wire(row, self.WIRE_ALPHA), Wire(row, self.WIRE_ALPHA + 1),
                Wire(row, self.WIRE_OLD_ACC), Wire(row, self.WIRE_OLD_ACC + 1)]
        deps += [Wire(row, self.WIRE_COEFFS + i) for i in range(self.num_coeffs)]
        outs = [Wire(row, self.wire_accs + j)
                for j in range(D * (self.num_coeffs - 1))]
        outs += [Wire(row, self.WIRE_OUTPUT), Wire(row, self.WIRE_OUTPUT + 1)]
        return [LambdaGenerator(deps, fn, outs=outs, op=("reduce",))]


class ReducingExtensionGate(Gate):
    """Horner fold of `num_coeffs` *extension* coefficients (D wires each):
    acc_i = acc_{i-1} * alpha + coeff_i."""

    def __init__(self, num_coeffs: int):
        if num_coeffs < 1:
            raise ValueError(
                f"ReducingExtensionGate needs num_coeffs >= 1, got {num_coeffs}")
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs(config) -> int:
        routed = (config.num_routed_wires - 3 * D) // D
        aux_room = (config.num_wires - 3 * D + D) // (2 * D)
        return max(1, min(routed, aux_room))

    def key(self) -> str:
        return f"ReducingExtension(num_coeffs={self.num_coeffs})"

    WIRE_OUTPUT = 0
    WIRE_ALPHA = D
    WIRE_OLD_ACC = 2 * D
    WIRE_COEFFS = 3 * D      # D * num_coeffs wires

    @property
    def wire_accs(self):
        return 3 * D + D * self.num_coeffs

    @property
    def num_routed(self):
        return 3 * D + D * self.num_coeffs

    @property
    def num_wires(self):
        return self.num_routed + D * (self.num_coeffs - 1)

    @property
    def degree(self):
        return 2

    @property
    def num_constraints(self):
        return D * self.num_coeffs

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        acc = (w[self.WIRE_OLD_ACC], w[self.WIRE_OLD_ACC + 1])
        alpha = (w[self.WIRE_ALPHA], w[self.WIRE_ALPHA + 1])
        for i in range(self.num_coeffs):
            if i < self.num_coeffs - 1:
                nxt = (w[self.wire_accs + D * i], w[self.wire_accs + D * i + 1])
            else:
                nxt = (w[self.WIRE_OUTPUT], w[self.WIRE_OUTPUT + 1])
            c = (w[self.WIRE_COEFFS + D * i], w[self.WIRE_COEFFS + D * i + 1])
            prod = _ext_mul(alg, acc, alpha)
            out.append(alg.sub(alg.add(prod[0], c[0]), nxt[0]))
            out.append(alg.sub(alg.add(prod[1], c[1]), nxt[1]))
            acc = nxt
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire

        def fn(vals, row=row):
            alpha = tuple(vals[0:2])
            acc = tuple(vals[2:4])
            out = []
            for i in range(self.num_coeffs):
                c = tuple(vals[4 + 2 * i:6 + 2 * i])
                acc = ext.add_s(ext.mul_s(acc, alpha), c)
                if i < self.num_coeffs - 1:
                    out.append((Wire(row, self.wire_accs + D * i), acc[0]))
                    out.append((Wire(row, self.wire_accs + D * i + 1), acc[1]))
            out.append((Wire(row, self.WIRE_OUTPUT), acc[0]))
            out.append((Wire(row, self.WIRE_OUTPUT + 1), acc[1]))
            return out

        deps = [Wire(row, self.WIRE_ALPHA), Wire(row, self.WIRE_ALPHA + 1),
                Wire(row, self.WIRE_OLD_ACC), Wire(row, self.WIRE_OLD_ACC + 1)]
        deps += [Wire(row, self.WIRE_COEFFS + j)
                 for j in range(D * self.num_coeffs)]
        outs = [Wire(row, self.wire_accs + j)
                for j in range(D * (self.num_coeffs - 1))]
        outs += [Wire(row, self.WIRE_OUTPUT), Wire(row, self.WIRE_OUTPUT + 1)]
        return [LambdaGenerator(deps, fn, outs=outs, op=("reduce_ext",))]
