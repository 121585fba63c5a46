"""BaseSumGate: positional decomposition of one wire into base-B limbs.

Host copy of `plonky2_tpu/gates/base_sum.py` (plonky2's BaseSumGate<B>,
placed by `split_le` / `split_le_base`).

Wires: [sum, limb_0, ..., limb_{L-1}], one instance per row.
Constraints: the recomposition sum - Σ limb_i B^i (degree 1) and, per
limb, the range product Π_{v<B} (limb - v) (degree B).
"""

from __future__ import annotations

import torch

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate


class BaseSumGate(Gate):
    WIRE_SUM = 0

    def __init__(self, base: int, num_limbs: int):
        if base < 2:
            raise ValueError(f"BaseSumGate needs base >= 2, got {base}")
        self.base = base
        self.num_limbs = num_limbs

    def key(self) -> str:
        return f"BaseSum(base={self.base},limbs={self.num_limbs})"

    @property
    def num_wires(self):
        return 1 + self.num_limbs

    @property
    def degree(self):
        return self.base

    @property
    def num_constraints(self):
        return 1 + self.num_limbs

    def wire_limb(self, i: int) -> int:
        return 1 + i

    def eval(self, vars, alg):
        out = []
        acc = alg.zero
        # Horner from the most significant limb
        for i in range(self.num_limbs - 1, -1, -1):
            acc = alg.add(alg.mul_const(self.base, acc),
                          vars.local_wires[self.wire_limb(i)])
        out.append(alg.sub(acc, vars.local_wires[self.WIRE_SUM]))
        for i in range(self.num_limbs):
            limb = vars.local_wires[self.wire_limb(i)]
            prod = limb
            for v in range(1, self.base):
                prod = alg.mul(prod, alg.add_const(limb, gl.P - v))
            out.append(prod)
        return out

    def eval_batch_fast(self, wires, constants, pi_hash):
        """wires: [num_wires, N] int64 -> [num_constraints, N]."""
        L, B = self.num_limbs, self.base
        limbs = wires[1:1 + L]
        weights = gl.to_tensor([pow(B, i, gl.P) for i in range(L)], wires.device)
        recomposed = gl.sub(gl.sum_mod(gl.mul(limbs, weights[:, None]), dim=0),
                            wires[self.WIRE_SUM])
        prod = limbs
        for v in range(1, B):
            prod = gl.mul(prod, gl.sub(limbs, gl.full_like(limbs, v)))
        return torch.cat([recomposed[None], prod], dim=0)

    def generators(self, row, constants):
        from ..ir.builder import Wire
        base, L = self.base, self.num_limbs

        def fn(vals, row=row):
            s = vals[0]
            out = []
            for i in range(L):
                out.append((Wire(row, self.wire_limb(i)), s % base))
                s //= base
            return out

        return [LambdaGenerator([Wire(row, self.WIRE_SUM)], fn,
                                outs=[Wire(row, self.wire_limb(i))
                                      for i in range(L)],
                                op=("basesum", base))]
