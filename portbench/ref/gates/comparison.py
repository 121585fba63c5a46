"""U32SubtractionGate and ComparisonGate.

Host copy of `plonky2_tpu/gates/comparison.py` (plonky2_u32's gates of the
same names).  Layout follows the u32 gates: the routed io block first, then
per-op aux base-4 range limbs that may lie past `num_routed_wires`.  Both
gates evaluate through the generic `eval` (no batch form), as in the JAX
package.
"""

from __future__ import annotations

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate
from .u32_arithmetic import _LIMBS, _fill_limbs, _range_constraints, _recompose


class U32SubtractionGate(Gate):
    """num_ops slots of: x - y - borrow_in -> (result u32, borrow_out bool),
    proving `x - y - bin = result - bout * 2^32` with result range-checked."""

    IO_WIRES = 5                     # x, y, borrow_in, result, borrow_out
    AUX_WIRES = _LIMBS

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config) -> "U32SubtractionGate":
        per_op = U32SubtractionGate.IO_WIRES + U32SubtractionGate.AUX_WIRES
        return U32SubtractionGate(max(1, min(
            config.num_wires // per_op,
            config.num_routed_wires // U32SubtractionGate.IO_WIRES)))

    def key(self) -> str:
        return f"U32Subtraction(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return (self.IO_WIRES + self.AUX_WIRES) * self.num_ops

    @property
    def degree(self):
        return 4

    @property
    def num_constraints(self):
        return self.num_ops * (3 + _LIMBS)

    def wires_op(self, i: int):
        b = self.IO_WIRES * i
        aux = self.IO_WIRES * self.num_ops + self.AUX_WIRES * i
        return dict(x=b, y=b + 1, borrow_in=b + 2, result=b + 3,
                    borrow_out=b + 4, limbs=aux)

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            x, y = w[ws["x"]], w[ws["y"]]
            bin_, res, bout = w[ws["borrow_in"]], w[ws["result"]], w[ws["borrow_out"]]
            diff = alg.sub(alg.sub(x, y), bin_)
            out.append(alg.sub(diff,
                               alg.sub(res, alg.mul_const(1 << 32, bout))))
            out.append(alg.mul(bout, alg.add_const(bout, gl.P - 1)))
            out.append(alg.sub(_recompose(alg, w, ws["limbs"], _LIMBS), res))
            out.extend(_range_constraints(alg, w, ws["limbs"], _LIMBS))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws):
                x, y, bin_ = vals
                d = x - y - bin_
                bout = 1 if d < 0 else 0
                return [(Wire(row, ws["result"]), d + (bout << 32)),
                        (Wire(row, ws["borrow_out"]), bout)]

            gens.append(LambdaGenerator(
                [Wire(row, ws["x"]), Wire(row, ws["y"]),
                 Wire(row, ws["borrow_in"])], fn,
                outs=[Wire(row, ws["result"]), Wire(row, ws["borrow_out"])],
                op=("u32sub",)))
        return gens

    def aux_fill(self, rows, wires):
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            _fill_limbs(wires, ws["result"], ws["limbs"], rows, _LIMBS)


class ComparisonGate(Gate):
    """One comparison of two `num_bits`-bit values: result = (a <= b).

    The witness picks e = result ? (b - a) : (a - b - 1); the constraint
    `e == (a - b - 1) + result*(2(b - a) + 1)`, a base-4 range check of e
    over num_bits bits and a booleanity check make the claim sound.  The
    caller guarantees a, b < 2^num_bits, and num_bits <= 62 keeps the
    differences from wrapping the field."""

    WIRE_A = 0
    WIRE_B = 1
    WIRE_RESULT = 2
    WIRE_E = 3
    WIRE_LIMBS = 4

    def __init__(self, num_bits: int = 32):
        if num_bits % 2 or num_bits > 62:
            raise ValueError(f"ComparisonGate needs an even num_bits <= 62, "
                             f"got {num_bits}")
        self.num_bits = num_bits

    def key(self) -> str:
        return f"Comparison(num_bits={self.num_bits})"

    @property
    def limbs(self):
        return self.num_bits // 2

    @property
    def num_wires(self):
        return 4 + self.limbs        # a, b, result, e, range limbs

    @property
    def degree(self):
        return 4

    @property
    def num_constraints(self):
        return 3 + self.limbs

    def eval(self, vars, alg):
        w = vars.local_wires
        a, b = w[self.WIRE_A], w[self.WIRE_B]
        res, e = w[self.WIRE_RESULT], w[self.WIRE_E]
        out = [alg.mul(res, alg.add_const(res, gl.P - 1))]
        base = alg.add_const(alg.sub(a, b), gl.P - 1)        # a - b - 1
        swing = alg.add_const(alg.mul_const(2, alg.sub(b, a)), 1)
        out.append(alg.sub(e, alg.add(base, alg.mul(res, swing))))
        out.append(alg.sub(_recompose(alg, w, self.WIRE_LIMBS, self.limbs), e))
        out.extend(_range_constraints(alg, w, self.WIRE_LIMBS, self.limbs))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire

        def fn(vals, row=row):
            a, b = vals
            res = 1 if a <= b else 0
            e = (b - a) if res else (a - b - 1)
            out = [(Wire(row, self.WIRE_RESULT), res),
                   (Wire(row, self.WIRE_E), e)]
            for j in range(self.limbs):
                out.append((Wire(row, self.WIRE_LIMBS + j), (e >> (2 * j)) & 3))
            return out

        return [LambdaGenerator(
            [Wire(row, self.WIRE_A), Wire(row, self.WIRE_B)], fn,
            outs=[Wire(row, self.WIRE_RESULT), Wire(row, self.WIRE_E)] +
                 [Wire(row, self.WIRE_LIMBS + j) for j in range(self.limbs)],
            op=("cmp",))]
