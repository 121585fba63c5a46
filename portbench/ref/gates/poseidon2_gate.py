"""Poseidon2Gate: one full width-12 Poseidon2 permutation per row.

Counterpart of `plonky2_tpu/gates/poseidon2_gate.py` (the reference's gate
whitelist ships Poseidon2Gate).  The 135-wire layout of poseidon_gate.py:

    0..11    inputs (routed)        12..23  outputs (routed)
    24       swap flag              25..28  delta_i
    29..64   s-box inputs of first-half external rounds r=1..3
    65..86   s-box inputs (lane 0) of the 22 internal rounds
    87..134  s-box inputs of second-half external rounds r=0..3

Unlike Poseidon: M_E is applied to the state before round 0 (linear, no
checkpoint), an internal round adds its constant to lane 0 only, and the
linear layers are M_E and M_I (hashes/poseidon2.py).  `eval` is the
generic-algebra definition, `eval_batch_fast` the tensor form the prover
uses on the LDE domain.  `Poseidon2Generator` fills every wire of the row
but the inputs and the swap flag; the witness tape runs it as a Python
escape, as the JAX tape does.
"""

from __future__ import annotations

import torch

from ..field import gl
from ..hashes import poseidon2 as p2
from ..hashes.poseidon import sbox
from ..witness import Generator
from .base import Gate
from .poseidon_gate import (NUM_WIRES, WIRE_DELTA, WIRE_FULL1, WIRE_FULL2,
                            WIRE_INPUT, WIRE_OUTPUT, WIRE_PARTIAL, WIRE_SWAP,
                            _swapped_state)

W = p2.WIDTH
HALF = p2.EXTERNAL_ROUNDS // 2


class Poseidon2Gate(Gate):
    def key(self) -> str:
        return "Poseidon2(width=12)"

    @property
    def num_wires(self):
        return NUM_WIRES

    @property
    def degree(self):
        return 7

    @property
    def num_constraints(self):
        return 1 + 4 + 36 + p2.INTERNAL_ROUNDS + 48 + 12

    # ---------------- generic evaluation ----------------

    def eval(self, vars, alg):
        w = vars.local_wires
        cs = []
        swap = w[WIRE_SWAP]
        cs.append(alg.mul(swap, alg.add_const(swap, gl.P - 1)))
        for i in range(4):
            diff = alg.sub(w[WIRE_INPUT + 4 + i], w[WIRE_INPUT + i])
            cs.append(alg.sub(alg.mul(swap, diff), w[WIRE_DELTA + i]))

        def sbox_alg(x):
            x2 = alg.mul(x, x)
            x3 = alg.mul(x2, x)
            return alg.mul(alg.mul(x3, x3), x)

        def matmul(m, state):
            out = []
            for i in range(W):
                acc = alg.mul_const(m[i][0], state[0])
                for j in range(1, W):
                    acc = alg.add(acc, alg.mul_const(m[i][j], state[j]))
                out.append(acc)
            return out

        s = []
        for i in range(4):
            s.append(alg.add(w[WIRE_INPUT + i], w[WIRE_DELTA + i]))
        for i in range(4):
            s.append(alg.sub(w[WIRE_INPUT + 4 + i], w[WIRE_DELTA + i]))
        for i in range(8, 12):
            s.append(w[WIRE_INPUT + i])

        s = matmul(p2.M_E, s)
        for r in range(HALF):
            s = [alg.add_const(x, p2.EXTERNAL_RCS[r][i]) for i, x in enumerate(s)]
            if r > 0:
                base = WIRE_FULL1 + 12 * (r - 1)
                for i in range(W):
                    cs.append(alg.sub(s[i], w[base + i]))
                s = [w[base + i] for i in range(W)]
            s = matmul(p2.M_E, [sbox_alg(x) for x in s])
        for r in range(p2.INTERNAL_ROUNDS):
            lane0 = alg.add_const(s[0], p2.INTERNAL_RCS[r])
            cs.append(alg.sub(lane0, w[WIRE_PARTIAL + r]))
            s = matmul(p2.M_I, [sbox_alg(w[WIRE_PARTIAL + r])] + s[1:])
        for fr in range(HALF):
            r = HALF + fr
            s = [alg.add_const(x, p2.EXTERNAL_RCS[r][i]) for i, x in enumerate(s)]
            base = WIRE_FULL2 + 12 * fr
            for i in range(W):
                cs.append(alg.sub(s[i], w[base + i]))
            s = matmul(p2.M_E, [sbox_alg(w[base + i]) for i in range(W)])
        for i in range(W):
            cs.append(alg.sub(w[WIRE_OUTPUT + i], s[i]))
        return cs

    # ---------------- stacked fast evaluation (prover) ----------------

    def eval_batch_fast(self, wires, constants, pi_hash):
        """wires: [num_wires, N] int64 -> [num_constraints, N]."""
        w = wires
        t = p2.tensors(w.device)
        me, mi, erc, irc = t["me"], t["mi"], t["erc"], t["irc"]
        cs = []
        swap = w[WIRE_SWAP]
        cs.append(gl.mul(swap, gl.sub(swap, torch.ones_like(swap))))
        ins = w[WIRE_INPUT:WIRE_INPUT + 12]
        delta = w[WIRE_DELTA:WIRE_DELTA + 4]
        cs.extend(gl.sub(gl.mul(swap[None], gl.sub(ins[4:8], ins[:4])), delta))

        s = p2.matmul_cols(me, _swapped_state(ins, delta))
        for r in range(HALF):
            s = gl.add(s, erc[r][:, None])
            if r > 0:
                base = WIRE_FULL1 + 12 * (r - 1)
                chk = w[base:base + 12]
                cs.extend(gl.sub(s, chk))
                s = chk
            s = p2.matmul_cols(me, sbox(s))
        for r in range(p2.INTERNAL_ROUNDS):
            lane0 = gl.add(s[0], irc[r].expand_as(s[0]))
            wk = w[WIRE_PARTIAL + r]
            cs.append(gl.sub(lane0, wk))
            s = p2.matmul_cols(mi, torch.cat([sbox(wk)[None], s[1:]], dim=0))
        for fr in range(HALF):
            s = gl.add(s, erc[HALF + fr][:, None])
            base = WIRE_FULL2 + 12 * fr
            chk = w[base:base + 12]
            cs.extend(gl.sub(s, chk))
            s = p2.matmul_cols(me, sbox(chk))
        cs.extend(gl.sub(w[WIRE_OUTPUT:WIRE_OUTPUT + 12], s))
        return torch.stack(cs, dim=0)

    # ---------------- witness ----------------

    def generators(self, row, constants):
        return [Poseidon2Generator(row)]


class Poseidon2Generator(Generator):
    """Fills the deltas, every s-box checkpoint and the outputs of a row
    from its 12 inputs and swap flag."""

    def __init__(self, row: int):
        from ..ir.builder import Wire
        self.row = row
        self.deps = [Wire(row, WIRE_INPUT + i) for i in range(W)] + \
                    [Wire(row, WIRE_SWAP)]
        self.outs = [Wire(row, c) for c in range(WIRE_OUTPUT, WIRE_OUTPUT + W)] + \
                    [Wire(row, c) for c in range(WIRE_DELTA, NUM_WIRES)]

    def run(self, get):
        from ..ir.builder import Wire
        row = self.row
        ins = [get(Wire(row, WIRE_INPUT + i)) for i in range(W)]
        swap = get(Wire(row, WIRE_SWAP))
        out = []
        delta = [(swap * ((ins[4 + i] - ins[i]) % gl.P)) % gl.P for i in range(4)]
        for i in range(4):
            out.append((Wire(row, WIRE_DELTA + i), delta[i]))

        s = [(ins[i] + delta[i]) % gl.P for i in range(4)] + \
            [(ins[4 + i] - delta[i]) % gl.P for i in range(4)] + ins[8:]

        s = p2._matmul_s(p2.M_E, s)
        for r in range(HALF):
            s = [(x + c) % gl.P for x, c in zip(s, p2.EXTERNAL_RCS[r])]
            if r > 0:
                base = WIRE_FULL1 + 12 * (r - 1)
                for i in range(W):
                    out.append((Wire(row, base + i), s[i]))
            s = p2._matmul_s(p2.M_E, [p2._sbox_s(x) for x in s])
        for r in range(p2.INTERNAL_ROUNDS):
            lane0 = (s[0] + p2.INTERNAL_RCS[r]) % gl.P
            out.append((Wire(row, WIRE_PARTIAL + r), lane0))
            s = p2._matmul_s(p2.M_I, [p2._sbox_s(lane0)] + s[1:])
        for fr in range(HALF):
            s = [(x + c) % gl.P for x, c in zip(s, p2.EXTERNAL_RCS[HALF + fr])]
            base = WIRE_FULL2 + 12 * fr
            for i in range(W):
                out.append((Wire(row, base + i), s[i]))
            s = p2._matmul_s(p2.M_E, [p2._sbox_s(x) for x in s])
        for i in range(W):
            out.append((Wire(row, WIRE_OUTPUT + i), s[i]))
        return out
