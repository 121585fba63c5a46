"""U32ArithmeticGate, U32AddManyGate and U32RangeCheckGate: packed 32-bit
ops with inline base-4 range decomposition.

Host copy of `plonky2_tpu/gates/u32_arithmetic.py` (plonky2_u32's gates of
the same names).  Each op carries its own lo/hi range limbs, so one row
proves `x*y + z = lo + hi*2^32` with both halves range-checked.  The
routed io block comes first, then the aux limbs, which may lie past
`num_routed_wires`; the scheduler's generators fill the io outputs and
`aux_fill` fills the limbs in one numpy pass per gate type.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate

_LIMBS = 16          # base-4 limbs per u32
_BASE = 4

_W4 = [1 << (2 * i) for i in range(_LIMBS)]


def _range_fast(limbs):
    """limbs [..., N] -> limb*(limb-1)*(limb-2)*(limb-3)."""
    p = gl.mul(limbs, gl.sub(limbs, gl.full_like(limbs, 1)))
    p = gl.mul(p, gl.sub(limbs, gl.full_like(limbs, 2)))
    return gl.mul(p, gl.sub(limbs, gl.full_like(limbs, 3)))


def _recompose_fast(limbs):
    """limbs [k, L, N] -> [k, N] base-4 recomposition."""
    w = gl.to_tensor(_W4[:limbs.shape[1]], limbs.device)
    return gl.sum_mod(gl.mul(limbs, w[None, :, None]), dim=1)


def _rows(wires, idx):
    """wires [W, N] gathered at a (nested) list of wire indices."""
    return wires[torch.as_tensor(idx, dtype=torch.long, device=wires.device)]


def _shift_32(hi):
    return gl.mul(hi, gl.full_like(hi, 1 << 32))


def _range_constraints(alg, wires, start, count):
    out = []
    for i in range(count):
        limb = wires[start + i]
        prod = limb
        for v in range(1, _BASE):
            prod = alg.mul(prod, alg.add_const(limb, gl.P - v))
        out.append(prod)
    return out


def _recompose(alg, wires, start, count):
    acc = alg.zero
    for i in range(count - 1, -1, -1):
        acc = alg.add(alg.mul_const(_BASE, acc), wires[start + i])
    return acc


def _fill_limbs(wires, src, dst, rows, count):
    """wires[dst + j, rows] = base-4 limb j of wires[src, rows] (numpy u64)."""
    v = wires[src, rows]
    for j in range(count):
        wires[dst + j, rows] = (v >> np.uint64(2 * j)) & np.uint64(3)


class U32ArithmeticGate(Gate):
    """num_ops slots of: x*y + z -> (lo, hi) as u32 halves.

    Wire layout: the routed io block first (5 wires per op: x, y, z, lo,
    hi), then the aux range-decomposition limbs (32 per op), so a 135-wire
    config packs 3 ops a row."""

    IO_WIRES = 5
    AUX_WIRES = 2 * _LIMBS

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config) -> "U32ArithmeticGate":
        per_op = U32ArithmeticGate.IO_WIRES + U32ArithmeticGate.AUX_WIRES
        return U32ArithmeticGate(max(1, min(
            config.num_wires // per_op,
            config.num_routed_wires // U32ArithmeticGate.IO_WIRES)))

    def key(self) -> str:
        return f"U32Arithmetic(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return (self.IO_WIRES + self.AUX_WIRES) * self.num_ops

    @property
    def degree(self):
        return _BASE

    @property
    def num_constraints(self):
        return self.num_ops * (3 + 2 * _LIMBS)

    def wires_op(self, i: int):
        b = self.IO_WIRES * i
        aux = self.IO_WIRES * self.num_ops + self.AUX_WIRES * i
        return dict(x=b, y=b + 1, z=b + 2, lo=b + 3, hi=b + 4,
                    lo_limbs=aux, hi_limbs=aux + _LIMBS)

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            x, y, z = w[ws["x"]], w[ws["y"]], w[ws["z"]]
            lo, hi = w[ws["lo"]], w[ws["hi"]]
            combined = alg.add(lo, alg.mul_const(1 << 32, hi))
            out.append(alg.sub(alg.add(alg.mul(x, y), z), combined))
            out.append(alg.sub(_recompose(alg, w, ws["lo_limbs"], _LIMBS), lo))
            out.append(alg.sub(_recompose(alg, w, ws["hi_limbs"], _LIMBS), hi))
            out.extend(_range_constraints(alg, w, ws["lo_limbs"], _LIMBS))
            out.extend(_range_constraints(alg, w, ws["hi_limbs"], _LIMBS))
        return out

    def eval_batch_fast(self, wires, constants, pi_hash):
        """wires: [num_wires, N] int64 -> [num_constraints, N], in `eval`'s
        order."""
        idx = [self.wires_op(i) for i in range(self.num_ops)]

        def g(k):
            return _rows(wires, [w[k] for w in idx])              # [ops, N]

        x, y, z, lo, hi = g("x"), g("y"), g("z"), g("lo"), g("hi")
        lo_limbs = _rows(wires, [[w["lo_limbs"] + j for j in range(_LIMBS)]
                                 for w in idx])                    # [ops, 16, N]
        hi_limbs = _rows(wires, [[w["hi_limbs"] + j for j in range(_LIMBS)]
                                 for w in idx])
        main = gl.sub(gl.add(gl.mul(x, y), z), gl.add(lo, _shift_32(hi)))
        rlo = gl.sub(_recompose_fast(lo_limbs), lo)
        rhi = gl.sub(_recompose_fast(hi_limbs), hi)
        out = torch.cat([main[:, None], rlo[:, None], rhi[:, None],
                         _range_fast(lo_limbs), _range_fast(hi_limbs)], dim=1)
        return out.reshape(-1, wires.shape[-1])

    def generators(self, row, constants):
        # Only the routed dataflow (x*y+z -> lo, hi) goes through the
        # scheduler; the 32 range limbs per op are filled by `aux_fill`.
        from ..ir.builder import Wire
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws):
                x, y, z = vals
                r = x * y + z
                return [(Wire(row, ws["lo"]), r & 0xFFFFFFFF),
                        (Wire(row, ws["hi"]), r >> 32)]

            gens.append(LambdaGenerator(
                [Wire(row, ws["x"]), Wire(row, ws["y"]), Wire(row, ws["z"])],
                fn, outs=[Wire(row, ws["lo"]), Wire(row, ws["hi"])],
                op=("u32muladd",)))
        return gens

    def aux_fill(self, rows, wires):
        """Limb fill for every row of this gate type: reads the lo/hi io
        wires of the numpy uint64 matrix and writes their base-4 limbs."""
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            _fill_limbs(wires, ws["lo"], ws["lo_limbs"], rows, _LIMBS)
            _fill_limbs(wires, ws["hi"], ws["hi_limbs"], rows, _LIMBS)


class U32AddManyGate(Gate):
    """num_ops slots of: sum(addends) + carry_in -> (lo u32, hi small).

    Per op: routed io (addends[n], carry_in, lo, hi), then aux limbs (16 lo
    + 2 hi), which may lie past num_routed_wires.  Needs n + max carry_in
    < 16 so that hi fits 2 base-4 limbs."""

    AUX_WIRES = _LIMBS + 2

    def __init__(self, num_addends: int, num_ops: int = 1):
        if not 2 <= num_addends <= 14:
            raise ValueError(f"U32AddManyGate takes 2..14 addends, got {num_addends}")
        self.num_addends = num_addends
        self.num_ops = num_ops

    @staticmethod
    def from_config(config, num_addends: int) -> "U32AddManyGate":
        io = num_addends + 3
        per_op = io + U32AddManyGate.AUX_WIRES
        return U32AddManyGate(num_addends, max(1, min(
            config.num_wires // per_op, config.num_routed_wires // io)))

    def key(self) -> str:
        return f"U32AddMany(num_addends={self.num_addends},num_ops={self.num_ops})"

    @property
    def io_wires(self):
        return self.num_addends + 3

    @property
    def num_wires(self):
        return (self.io_wires + self.AUX_WIRES) * self.num_ops

    @property
    def degree(self):
        return _BASE

    @property
    def num_constraints(self):
        return self.num_ops * (3 + _LIMBS + 2)

    def wires_op(self, i: int):
        n = self.num_addends
        b = self.io_wires * i
        aux = self.io_wires * self.num_ops + self.AUX_WIRES * i
        return dict(addends=b, carry_in=b + n, lo=b + n + 1, hi=b + n + 2,
                    lo_limbs=aux, hi_limbs=aux + _LIMBS)

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            acc = w[ws["carry_in"]]
            for j in range(self.num_addends):
                acc = alg.add(acc, w[ws["addends"] + j])
            lo, hi = w[ws["lo"]], w[ws["hi"]]
            out.append(alg.sub(acc, alg.add(lo, alg.mul_const(1 << 32, hi))))
            out.append(alg.sub(_recompose(alg, w, ws["lo_limbs"], _LIMBS), lo))
            out.append(alg.sub(_recompose(alg, w, ws["hi_limbs"], 2), hi))
            out.extend(_range_constraints(alg, w, ws["lo_limbs"], _LIMBS))
            out.extend(_range_constraints(alg, w, ws["hi_limbs"], 2))
        return out

    def eval_batch_fast(self, wires, constants, pi_hash):
        n = self.num_addends
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            addends = _rows(wires, [ws["addends"] + j for j in range(n)])
            cin, lo, hi = wires[ws["carry_in"]], wires[ws["lo"]], wires[ws["hi"]]
            lo_limbs = _rows(wires, [[ws["lo_limbs"] + j for j in range(_LIMBS)]])
            hi_limbs = _rows(wires, [[ws["hi_limbs"] + j for j in range(2)]])
            total = gl.add(gl.sum_mod(addends, dim=0), cin)
            out += [gl.sub(total, gl.add(lo, _shift_32(hi)))[None],
                    gl.sub(_recompose_fast(lo_limbs), lo),
                    gl.sub(_recompose_fast(hi_limbs), hi),
                    _range_fast(lo_limbs[0]), _range_fast(hi_limbs[0])]
        return torch.cat(out, dim=0)

    def generators(self, row, constants):
        from ..ir.builder import Wire
        n = self.num_addends
        gens = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)

            def fn(vals, row=row, ws=ws):
                s = sum(vals)
                return [(Wire(row, ws["lo"]), s & 0xFFFFFFFF),
                        (Wire(row, ws["hi"]), s >> 32)]

            deps = [Wire(row, ws["addends"] + j) for j in range(n)] + \
                   [Wire(row, ws["carry_in"])]
            gens.append(LambdaGenerator(
                deps, fn, outs=[Wire(row, ws["lo"]), Wire(row, ws["hi"])],
                op=("u32addmany",)))
        return gens

    def aux_fill(self, rows, wires):
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            _fill_limbs(wires, ws["lo"], ws["lo_limbs"], rows, _LIMBS)
            _fill_limbs(wires, ws["hi"], ws["hi_limbs"], rows, 2)


class U32RangeCheckGate(Gate):
    """num_ops packed u32 range checks: a routed value and its 16 aux
    base-4 limbs."""

    IO_WIRES = 1
    AUX_WIRES = _LIMBS

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @staticmethod
    def from_config(config) -> "U32RangeCheckGate":
        per_op = U32RangeCheckGate.IO_WIRES + U32RangeCheckGate.AUX_WIRES
        return U32RangeCheckGate(max(1, min(config.num_wires // per_op,
                                            config.num_routed_wires)))

    def key(self) -> str:
        return f"U32RangeCheck(num_ops={self.num_ops})"

    @property
    def num_wires(self):
        return (self.IO_WIRES + self.AUX_WIRES) * self.num_ops

    @property
    def degree(self):
        return _BASE

    @property
    def num_constraints(self):
        return self.num_ops * (1 + _LIMBS)

    def wires_op(self, i: int):
        return dict(x=i, limbs=self.num_ops + self.AUX_WIRES * i)

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            out.append(alg.sub(_recompose(alg, w, ws["limbs"], _LIMBS),
                               w[ws["x"]]))
            out.extend(_range_constraints(alg, w, ws["limbs"], _LIMBS))
        return out

    def eval_batch_fast(self, wires, constants, pi_hash):
        idx = [self.wires_op(i) for i in range(self.num_ops)]
        x = _rows(wires, [w["x"] for w in idx])
        limbs = _rows(wires, [[w["limbs"] + j for j in range(_LIMBS)]
                              for w in idx])
        rc = gl.sub(_recompose_fast(limbs), x)
        out = torch.cat([rc[:, None], _range_fast(limbs)], dim=1)
        return out.reshape(-1, wires.shape[-1])

    def generators(self, row, constants):
        # Every helper wire derives from the routed input in `aux_fill`.
        return []

    def aux_fill(self, rows, wires):
        for i in range(self.num_ops):
            ws = self.wires_op(i)
            _fill_limbs(wires, ws["x"], ws["limbs"], rows, _LIMBS)
