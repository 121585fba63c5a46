"""Interleave / uninterleave gates: XOR and AND through addition.

Host copy of `plonky2_tpu/gates/u32_interleave.py`:

* `U32InterleaveGate`: x (u32) -> x_interleaved, bit i moved to bit 2i.
  The sum of two interleaved values holds the XOR in its even bits and the
  AND in its odd bits.
* `UninterleaveToU32Gate`: decompose such a sum into 64 bits; the packed
  even bits (XOR) and odd bits (AND) come out as plain u32.
* `UninterleaveToB32Gate`: the same decomposition, the outputs kept in
  interleaved (B32) form so that chained XORs can keep adding (the
  soundness caveat of interleaved sums that exceed the field order carries
  over, see `gadgets/u32.py` `unsafe_xor_many_u32`).

Every helper wire is written by the generators; no gate here has an
`aux_fill`.  The 64-bit weights 2^i reach 2^63, which does not fit int64,
so they go to tensors as u64 bit patterns (`gl.to_tensor`).
"""

from __future__ import annotations

import torch

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate
from .u32_arithmetic import _rows


def _bool_constraint(alg, b):
    return alg.mul(b, alg.add_const(b, gl.P - 1))


def _bool_fast(bits):
    return gl.mul(bits, gl.sub(bits, gl.full_like(bits, 1)))


def _wsum(bits, weights):
    """bits [k, L, N] x weights [L] (Python ints < p) -> [k, N]."""
    w = gl.to_tensor(weights, bits.device)
    return gl.sum_mod(gl.mul(bits, w[None, :, None]), dim=1)


class U32InterleaveGate(Gate):
    """Per op: routed (x, x_interleaved), aux (32 bits, which may lie past
    the routed region)."""

    IO_WIRES = 2
    AUX_WIRES = 32

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config):
        per_op = U32InterleaveGate.IO_WIRES + U32InterleaveGate.AUX_WIRES
        return U32InterleaveGate(max(1, min(
            config.num_wires // per_op,
            config.num_routed_wires // U32InterleaveGate.IO_WIRES)))

    def key(self):
        return f"U32Interleave(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return (self.IO_WIRES + self.AUX_WIRES) * self.num_ops

    @property
    def degree(self):
        return 2

    @property
    def num_constraints(self):
        return self.num_ops * 34

    def wires_op(self, i):
        b = self.IO_WIRES * i
        aux = self.IO_WIRES * self.num_ops + self.AUX_WIRES * i
        return dict(x=b, x_il=b + 1, bits=aux)

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            bits = [w[ws["bits"] + j] for j in range(32)]
            acc2 = alg.zero
            acc4 = alg.zero
            for j in range(31, -1, -1):
                acc2 = alg.add(alg.mul_const(2, acc2), bits[j])
                acc4 = alg.add(alg.mul_const(4, acc4), bits[j])
            out.append(alg.sub(acc2, w[ws["x"]]))
            out.append(alg.sub(acc4, w[ws["x_il"]]))
            out.extend(_bool_constraint(alg, b) for b in bits)
        return out

    def eval_batch_fast(self, wires, constants, pi_hash):
        """wires: [num_wires, N] int64 -> [num_constraints, N], in `eval`'s
        order."""
        idx = [self.wires_op(i) for i in range(self.num_ops)]
        x = _rows(wires, [w["x"] for w in idx])
        x_il = _rows(wires, [w["x_il"] for w in idx])
        bits = _rows(wires, [[w["bits"] + j for j in range(32)]
                             for w in idx])                      # [ops, 32, N]
        r2 = gl.sub(_wsum(bits, [1 << i for i in range(32)]), x)
        r4 = gl.sub(_wsum(bits, [1 << (2 * i) for i in range(32)]), x_il)
        out = torch.cat([r2[:, None], r4[:, None], _bool_fast(bits)], dim=1)
        return out.reshape(-1, wires.shape[-1])

    def generators(self, row, constants):
        from ..ir.builder import Wire
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws):
                x = vals[0]
                out = []
                il = 0
                for j in range(32):
                    b = (x >> j) & 1
                    il |= b << (2 * j)
                    out.append((Wire(row, ws["bits"] + j), b))
                out.append((Wire(row, ws["x_il"]), il))
                return out

            gens.append(LambdaGenerator(
                [Wire(row, ws["x"])], fn,
                outs=[Wire(row, ws["x_il"])] +
                     [Wire(row, ws["bits"] + j) for j in range(32)],
                op=("interleave",)))
        return gens


class _UninterleaveBase(Gate):
    """Shared: a dirty 64-bit input, 64 bit wires and 2 packed outputs.

    Per-op wires: x_dirty, out_evens, out_odds, then the 64 bits."""

    IO_WIRES = 3
    AUX_WIRES = 64
    # subclass sets the packing base of the outputs: 2 (u32) or 4 (B32)
    PACK_BASE = None
    NAME = None

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @classmethod
    def from_config(cls, config):
        return cls(max(1, min(config.num_wires // (cls.IO_WIRES + cls.AUX_WIRES),
                              config.num_routed_wires // cls.IO_WIRES)))

    def key(self):
        return f"{self.NAME}(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return (self.IO_WIRES + self.AUX_WIRES) * self.num_ops

    @property
    def degree(self):
        return 2

    @property
    def num_constraints(self):
        return self.num_ops * 67

    def wires_op(self, i):
        b = self.IO_WIRES * i
        aux = self.IO_WIRES * self.num_ops + self.AUX_WIRES * i
        return dict(x=b, evens=b + 1, odds=b + 2, bits=aux)

    def eval(self, vars, alg):
        w = vars.local_wires
        B = self.PACK_BASE
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            bits = [w[ws["bits"] + j] for j in range(64)]
            acc2 = alg.zero
            for j in range(63, -1, -1):
                acc2 = alg.add(alg.mul_const(2, acc2), bits[j])
            out.append(alg.sub(acc2, w[ws["x"]]))
            acc_e = alg.zero
            acc_o = alg.zero
            for j in range(31, -1, -1):
                acc_e = alg.add(alg.mul_const(B, acc_e), bits[2 * j])
                acc_o = alg.add(alg.mul_const(B, acc_o), bits[2 * j + 1])
            out.append(alg.sub(acc_e, w[ws["evens"]]))
            out.append(alg.sub(acc_o, w[ws["odds"]]))
            out.extend(_bool_constraint(alg, b) for b in bits)
        return out

    def eval_batch_fast(self, wires, constants, pi_hash):
        B = self.PACK_BASE
        idx = [self.wires_op(i) for i in range(self.num_ops)]
        x = _rows(wires, [w["x"] for w in idx])
        evens = _rows(wires, [w["evens"] for w in idx])
        odds = _rows(wires, [w["odds"] for w in idx])
        bits = _rows(wires, [[w["bits"] + j for j in range(64)]
                             for w in idx])                      # [ops, 64, N]
        r2 = gl.sub(_wsum(bits, [(1 << i) % gl.P for i in range(64)]), x)
        wB = [pow(B, i, gl.P) for i in range(32)]
        re = gl.sub(_wsum(bits[:, 0::2], wB), evens)
        ro = gl.sub(_wsum(bits[:, 1::2], wB), odds)
        out = torch.cat([r2[:, None], re[:, None], ro[:, None],
                         _bool_fast(bits)], dim=1)
        return out.reshape(-1, wires.shape[-1])

    def generators(self, row, constants):
        from ..ir.builder import Wire
        B = self.PACK_BASE
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws):
                x = vals[0]
                out = []
                ev = od = 0
                for j in range(64):
                    b = (x >> j) & 1
                    out.append((Wire(row, ws["bits"] + j), b))
                for j in range(32):
                    ev += ((x >> (2 * j)) & 1) * (B ** j)
                    od += ((x >> (2 * j + 1)) & 1) * (B ** j)
                out.append((Wire(row, ws["evens"]), ev))
                out.append((Wire(row, ws["odds"]), od))
                return out

            gens.append(LambdaGenerator(
                [Wire(row, ws["x"])], fn,
                outs=[Wire(row, ws["evens"]), Wire(row, ws["odds"])] +
                     [Wire(row, ws["bits"] + j) for j in range(64)],
                op=("uninterleave", B)))
        return gens


class UninterleaveToU32Gate(_UninterleaveBase):
    PACK_BASE = 2
    NAME = "UninterleaveToU32"


class UninterleaveToB32Gate(_UninterleaveBase):
    PACK_BASE = 4
    NAME = "UninterleaveToB32"
