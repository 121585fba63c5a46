"""u32 arithmetic and bitwise gadgets.

Host copy of `plonky2_tpu/gadgets/u32.py` (plonky2_u32's
`CircuitBuilderU32` and the `CircuitBuilderB32` of the interleaved-bits
representation): not/lsh/rsh/lrot/rrot through power-of-two multiplies,
XOR/AND through interleaved bits (one add a pairwise op), the amortized
`unsafe_xor_many_*` chain, and 64-bit ops as [U32Target; 2] pairs.

The functions are attached to `CircuitBuilder` as methods at import.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl
from ..gates.comparison import U32SubtractionGate
from ..gates.u32_arithmetic import (U32AddManyGate, U32ArithmeticGate,
                                    U32RangeCheckGate)
from ..gates.u32_interleave import (U32InterleaveGate, UninterleaveToB32Gate,
                                    UninterleaveToU32Gate)
from ..ir.builder import Wire
from . import attach


@dataclass(frozen=True)
class U32Target:
    target: object


@dataclass(frozen=True)
class B32Target:
    target: object


# ------------------------------------------------------------------
# creation / range checks
# ------------------------------------------------------------------

def add_virtual_u32_target(self) -> U32Target:
    """Fresh u32 target, range-checked."""
    t = self.add_virtual_target()
    self.range_check_u32(t)
    return U32Target(t)


def add_virtual_u32_target_unsafe(self) -> U32Target:
    return U32Target(self.add_virtual_target())


def range_check_u32(self, t) -> None:
    gate = U32RangeCheckGate.from_config(self.config)
    row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_ops)
    self.connect(t, Wire(row, gate.wires_op(slot)["x"]))


def constant_u32(self, c: int) -> U32Target:
    if not 0 <= c < 1 << 32:
        raise ValueError(f"{c} is not a u32")
    return U32Target(self.constant(c))


def zero_u32(self) -> U32Target:
    return U32Target(self.zero())


def one_u32(self) -> U32Target:
    return U32Target(self.one())


def connect_u32(self, a: U32Target, b: U32Target) -> None:
    self.connect(a.target, b.target)


def assert_zero_u32(self, a: U32Target) -> None:
    self.assert_zero(a.target)


# ------------------------------------------------------------------
# arithmetic (U32ArithmeticGate / U32AddManyGate / U32SubtractionGate)
# ------------------------------------------------------------------

def mul_add_u32(self, x: U32Target, y: U32Target, z: U32Target):
    """x*y + z -> (lo, hi), both range-checked by the gate."""
    gate = U32ArithmeticGate.from_config(self.config)
    row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_ops)
    ws = gate.wires_op(slot)
    self.connect(x.target, Wire(row, ws["x"]))
    self.connect(y.target, Wire(row, ws["y"]))
    self.connect(z.target, Wire(row, ws["z"]))
    lo = self.add_virtual_target()
    hi = self.add_virtual_target()
    self.connect(lo, Wire(row, ws["lo"]))
    self.connect(hi, Wire(row, ws["hi"]))
    return U32Target(lo), U32Target(hi)


def mul_u32(self, x: U32Target, y: U32Target):
    return self.mul_add_u32(x, y, self.zero_u32())


def add_u32(self, a: U32Target, b: U32Target):
    """(sum, carry): the defining equation forces carry in {0, 1}."""
    return self.mul_add_u32(a, self.one_u32(), b)


def add_u32s_with_carry(self, addends: list, carry_in: U32Target):
    """sum(addends) + carry_in -> (lo, carry_out)."""
    xs = list(addends)
    if len(xs) == 1:
        return self.add_u32(xs[0], carry_in)
    lo = None
    total_hi = None
    cin = carry_in
    while xs:
        chunk, xs = xs[:13], xs[13:]
        # widths normalized to {4, 13}: fewer gate variants, fewer selectors
        width = 4 if len(chunk) <= 4 else 13
        chunk = chunk + [self.zero_u32()] * (width - len(chunk))
        gate = U32AddManyGate.from_config(self.config, len(chunk))
        row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_ops)
        ws = gate.wires_op(slot)
        for i, a in enumerate(chunk):
            self.connect(a.target, Wire(row, ws["addends"] + i))
        self.connect(cin.target, Wire(row, ws["carry_in"]))
        lo_t = self.add_virtual_target()
        hi_t = self.add_virtual_target()
        self.connect(lo_t, Wire(row, ws["lo"]))
        self.connect(hi_t, Wire(row, ws["hi"]))
        lo = U32Target(lo_t)
        total_hi = hi_t if total_hi is None else self.add(total_hi, hi_t)
        if xs:
            xs.insert(0, lo)
            cin = self.zero_u32()
    return lo, U32Target(total_hi)


def add_many_u32(self, addends: list):
    return self.add_u32s_with_carry(addends, self.zero_u32())


def sub_u32(self, a: U32Target, b: U32Target, borrow_in: U32Target):
    """a - b - borrow_in -> (diff, borrow_out), borrows in {0, 1} (one
    U32SubtractionGate op slot)."""
    gate = U32SubtractionGate.from_config(self.config)
    row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_ops)
    ws = gate.wires_op(slot)
    self.connect(a.target, Wire(row, ws["x"]))
    self.connect(b.target, Wire(row, ws["y"]))
    self.connect(borrow_in.target, Wire(row, ws["borrow_in"]))
    res = self.add_virtual_target()
    bout = self.add_virtual_target()
    self.connect(res, Wire(row, ws["result"]))
    self.connect(bout, Wire(row, ws["borrow_out"]))
    return U32Target(res), U32Target(bout)


def is_less_than_u32(self, a: U32Target, b: U32Target):
    """Boolean target: a < b (the subtraction's borrow)."""
    _, borrow = self.sub_u32(a, b, self.zero_u32())
    return borrow.target


# ------------------------------------------------------------------
# bitwise through power-of-two multiplies
# ------------------------------------------------------------------

def not_u32(self, a: U32Target) -> U32Target:
    # 0xFFFFFFFF - a  (affine; stays in range)
    return U32Target(self.arithmetic(gl.P - 1, 0xFFFFFFFF, a.target,
                                     self.one(), self.one()))


def lsh_u32(self, a: U32Target, n: int) -> U32Target:
    if n == 0:
        return a
    return self.mul_u32(a, self.constant_u32(1 << n))[0]


def rsh_u32(self, a: U32Target, n: int) -> U32Target:
    if n == 0:
        return a
    return self.mul_u32(a, self.constant_u32(1 << (32 - n)))[1]


def lrot_u32(self, a: U32Target, n: int) -> U32Target:
    n %= 32
    if n == 0:
        return a
    lo, hi = self.mul_u32(a, self.constant_u32(1 << n))
    return self.add_u32(lo, hi)[0]


def rrot_u32(self, a: U32Target, n: int) -> U32Target:
    return self.lrot_u32(a, (32 - n) % 32)


def conditional_u32(self, x: U32Target, y: U32Target, b) -> U32Target:
    """b ? x : y (b a boolean target)."""
    return U32Target(self.select(b, x.target, y.target))


# ------------------------------------------------------------------
# interleaved representation
# ------------------------------------------------------------------

def interleave_u32(self, x: U32Target) -> B32Target:
    gate = U32InterleaveGate.from_config(self.config)
    row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_ops)
    ws = gate.wires_op(slot)
    self.connect(x.target, Wire(row, ws["x"]))
    out = self.add_virtual_target()
    self.connect(out, Wire(row, ws["x_il"]))
    return B32Target(out)


def _uninterleave(self, x_dirty, gate_cls):
    gate = gate_cls.from_config(self.config)
    row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_ops)
    ws = gate.wires_op(slot)
    self.connect(x_dirty, Wire(row, ws["x"]))
    evens = self.add_virtual_target()
    odds = self.add_virtual_target()
    self.connect(evens, Wire(row, ws["evens"]))
    self.connect(odds, Wire(row, ws["odds"]))
    # bit j of x lands at position 2j => even bits = XOR, odd bits = AND
    return odds, evens  # (and, xor)


def uninterleave_to_u32(self, x_dirty):
    """dirty interleaved sum -> (and: U32Target, xor: U32Target)."""
    a, x = self._uninterleave(x_dirty, UninterleaveToU32Gate)
    return U32Target(a), U32Target(x)


def uninterleave_to_b32(self, x_dirty):
    a, x = self._uninterleave(x_dirty, UninterleaveToB32Gate)
    return B32Target(a), B32Target(x)


def and_xor_b32(self, x: B32Target, y: B32Target):
    return self.uninterleave_to_b32(self.add(x.target, y.target))


def and_xor_u32(self, x: U32Target, y: U32Target):
    return self.and_xor_b32(self.interleave_u32(x), self.interleave_u32(y))


def and_xor_b32_to_u32(self, x: B32Target, y: B32Target):
    return self.uninterleave_to_u32(self.add(x.target, y.target))


def and_xor_u32_to_u32(self, x: U32Target, y: U32Target):
    return self.and_xor_b32_to_u32(self.interleave_u32(x),
                                   self.interleave_u32(y))


def and_u32(self, x: U32Target, y: U32Target) -> U32Target:
    return self.and_xor_u32_to_u32(x, y)[0]


def xor_u32(self, x: U32Target, y: U32Target) -> U32Target:
    return self.and_xor_u32_to_u32(x, y)[1]


def unsafe_xor_many_u32(self, xs: list) -> U32Target:
    """Amortized chained XOR: one uninterleave per two adds.  Unsound when
    an interleaved sum exceeds the field order (plonky2's interleaved-u32
    caveat); the caller bounds the chain."""
    n = len(xs)
    if n == 0:
        return self.zero_u32()
    if n == 1:
        return xs[0]
    if n == 2:
        return self.xor_u32(xs[0], xs[1])
    if n == 3:
        return self.xor_u32(self.xor_u32(xs[0], xs[1]), xs[2])
    r = self.interleave_u32(xs[0])
    for i in range((n - 3) // 2):
        i1 = self.interleave_u32(xs[1 + 2 * i])
        i2 = self.interleave_u32(xs[2 + 2 * i])
        t = self.add(self.add(r.target, i1.target), i2.target)
        r = self.uninterleave_to_b32(t)[1]
    if n % 2 == 0:
        r = self.and_xor_b32(r, self.interleave_u32(xs[n - 3]))[1]
    i1 = self.interleave_u32(xs[n - 2])
    i2 = self.interleave_u32(xs[n - 1])
    t = self.add(self.add(r.target, i1.target), i2.target)
    return self.uninterleave_to_u32(t)[1]


# ------------------------------------------------------------------
# 64-bit pairs
# ------------------------------------------------------------------

def not_u64(self, x):
    return [self.not_u32(x[0]), self.not_u32(x[1])]


def lrot_u64(self, a, n: int):
    n %= 64
    lo, hi = (a[0], a[1]) if n < 32 else (a[1], a[0])
    n %= 32
    if n == 0:
        return [lo, hi]
    p = self.constant_u32(1 << n)
    lo0, hi0 = self.mul_u32(lo, p)
    lo1, hi1 = self.mul_add_u32(hi, p, hi0)
    return [self.add_u32(lo0, hi1)[0], lo1]


def xor_u64(self, x, y):
    return [self.xor_u32(x[0], y[0]), self.xor_u32(x[1], y[1])]


def and_u64(self, x, y):
    return [self.and_u32(x[0], y[0]), self.and_u32(x[1], y[1])]


def unsafe_xor_many_u64(self, xs):
    return [self.unsafe_xor_many_u32([el[0] for el in xs]),
            self.unsafe_xor_many_u32([el[1] for el in xs])]


def conditional_u64(self, x, y, b):
    return [self.conditional_u32(x[0], y[0], b),
            self.conditional_u32(x[1], y[1], b)]


# ------------------------------------------------------------------
# attach to CircuitBuilder
# ------------------------------------------------------------------

attach(globals())
