"""RandomAccessGate: constrained dynamic indexing into a routed list.

Host copy of `plonky2_tpu/gates/random_access.py` (plonky2's
RandomAccessGate, placed by `CircuitBuilder.random_access`; the secp256k1
curve gadgets select window-table limbs through it).  Each copy proves
`claimed == items[index]` for a 2^bits-entry routed list: the index is
split into `bits` aux bit wires and the list is folded by a binary mux
tree inside the constraint.  One copy takes 2 + 2^bits routed wires and
`bits` aux wires.

Constraints of a copy:
  * each aux bit is boolean                       (bits constraints, deg 2)
  * sum(bit_i * 2^i) == index                     (1 constraint,  deg 1)
  * the mux-tree fold of items by bits == claimed (1 constraint,  deg bits+1)

The prover evaluates the generic `eval` under `BatchAlg`, as the JAX
package does: there is no batch form.
"""

from __future__ import annotations

from ..field import gl
from ..witness import LambdaGenerator
from .base import Gate


class RandomAccessGate(Gate):
    def __init__(self, bits: int, num_copies: int):
        if bits < 1:
            raise ValueError(f"RandomAccessGate needs bits >= 1, got {bits}")
        self.bits = bits
        self.num_copies = num_copies

    @property
    def vec_size(self) -> int:
        return 1 << self.bits

    @staticmethod
    def from_config(config, bits: int) -> "RandomAccessGate":
        io = 2 + (1 << bits)
        copies = max(1, min(config.num_routed_wires // io,
                            config.num_wires // (io + bits)))
        return RandomAccessGate(bits, copies)

    def key(self) -> str:
        return f"RandomAccess(bits={self.bits},num_copies={self.num_copies})"

    @property
    def io_wires(self) -> int:
        return 2 + self.vec_size

    @property
    def num_wires(self) -> int:
        return (self.io_wires + self.bits) * self.num_copies

    @property
    def degree(self) -> int:
        return max(2, self.bits + 1)

    @property
    def num_constraints(self) -> int:
        return self.num_copies * (self.bits + 2)

    def wires_copy(self, c: int) -> dict:
        """Copy c's routed index, claimed value and first item, and its
        first aux bit (the aux bits of every copy follow the routed ones)."""
        b = self.io_wires * c
        aux = self.io_wires * self.num_copies + self.bits * c
        return dict(index=b, claimed=b + 1, items=b + 2, bits=aux)

    def eval(self, vars, alg):
        w = vars.local_wires
        out = []
        for c in range(self.num_copies):
            ws = self.wires_copy(c)
            bits = [w[ws["bits"] + i] for i in range(self.bits)]
            for b in bits:
                out.append(alg.mul(b, alg.add_const(b, gl.P - 1)))
            acc = alg.zero
            for b in reversed(bits):
                acc = alg.add(alg.add(acc, acc), b)
            out.append(alg.sub(acc, w[ws["index"]]))
            layer = [w[ws["items"] + i] for i in range(self.vec_size)]
            for b in bits:
                layer = [alg.add(layer[2 * i],
                                 alg.mul(b, alg.sub(layer[2 * i + 1],
                                                    layer[2 * i])))
                         for i in range(len(layer) // 2)]
            out.append(alg.sub(layer[0], w[ws["claimed"]]))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        gens = []
        for c in range(self.num_copies):
            ws = self.wires_copy(c)

            def fn(vals, row=row, ws=ws):
                idx, items = vals[0], vals[1:]
                out = [(Wire(row, ws["bits"] + i), (idx >> i) & 1)
                       for i in range(self.bits)]
                out.append((Wire(row, ws["claimed"]), items[idx]))
                return out

            gens.append(LambdaGenerator(
                [Wire(row, ws["index"])] +
                [Wire(row, ws["items"] + i) for i in range(self.vec_size)],
                fn,
                outs=[Wire(row, ws["bits"] + i) for i in range(self.bits)] +
                     [Wire(row, ws["claimed"])]))
        return gens
