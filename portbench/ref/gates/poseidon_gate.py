"""PoseidonGate: one full width-12 permutation per row.

Counterpart of `plonky2_tpu/gates/poseidon_gate.py`, same wire layout
(135 wires):

    0..11    inputs (routed)
    12..23   outputs (routed)
    24       swap flag (routed) — swaps input[0..4] with input[4..8]
    25..28   delta_i = swap * (input[4+i] - input[i])
    29..64   s-box inputs of first-half full rounds r=1..3 (12 each)
    65..86   s-box inputs (lane 0) of the 22 partial rounds
    87..134  s-box inputs of second-half full rounds r=0..3 (12 each)

123 constraints: 1 swap-boolean + 4 delta + 36 + 22 + 48 checkpoint + 12
output.  `eval` is the generic-algebra definition; `eval_batch_fast` is
the stacked tensor form the prover uses on the LDE domain ([12, N] state,
so the MDS layer is one broadcast multiply and sum).  `aux_fill` computes
the 110 internal wires of every Poseidon row at once from the plain
permutation's rounds.
"""

from __future__ import annotations

import torch

from ..field import gl
from ..hashes import poseidon
from ..witness import Generator
from .base import Gate

W = poseidon.WIDTH

WIRE_INPUT = 0
WIRE_OUTPUT = 12
WIRE_SWAP = 24
WIRE_DELTA = 25
WIRE_FULL1 = 29              # rounds 1..3, 12 each
WIRE_PARTIAL = 65            # 22 lanes
WIRE_FULL2 = 87              # rounds 0..3, 12 each
NUM_WIRES = 135
NUM_AUX = 4 + 3 * W + poseidon.PARTIAL_ROUNDS + 4 * W   # wires 25..134


def _swapped_state(ins, delta):
    """[12, ...] inputs and [4, ...] deltas -> the swapped input state."""
    return torch.cat([gl.add(ins[:4], delta), gl.sub(ins[4:8], delta), ins[8:12]],
                     dim=0)


class PoseidonGate(Gate):
    def key(self) -> str:
        return "Poseidon(width=12)"

    @property
    def num_wires(self):
        return NUM_WIRES

    @property
    def degree(self):
        return 7

    @property
    def num_constraints(self):
        return 1 + 4 + 36 + 22 + 48 + 12

    # ---------------- generic evaluation ----------------

    def eval(self, vars, alg):
        w = vars.local_wires
        cs = []
        swap = w[WIRE_SWAP]
        cs.append(alg.mul(swap, alg.add_const(swap, gl.P - 1)))
        for i in range(4):
            diff = alg.sub(w[WIRE_INPUT + 4 + i], w[WIRE_INPUT + i])
            cs.append(alg.sub(alg.mul(swap, diff), w[WIRE_DELTA + i]))

        def sbox(x):
            x2 = alg.mul(x, x)
            x3 = alg.mul(x2, x)
            return alg.mul(alg.mul(x3, x3), x)

        def mds(state):
            out = []
            for i in range(W):
                acc = alg.mul_const(poseidon.MDS[i][0], state[0])
                for j in range(1, W):
                    acc = alg.add(acc, alg.mul_const(poseidon.MDS[i][j], state[j]))
                out.append(acc)
            return out

        s = []
        for i in range(4):
            s.append(alg.add(w[WIRE_INPUT + i], w[WIRE_DELTA + i]))
        for i in range(4):
            s.append(alg.sub(w[WIRE_INPUT + 4 + i], w[WIRE_DELTA + i]))
        for i in range(8, 12):
            s.append(w[WIRE_INPUT + i])

        r = 0
        for fr in range(4):
            s = [alg.add_const(x, poseidon.ROUND_CONSTANTS[r][i])
                 for i, x in enumerate(s)]
            if fr > 0:
                base = WIRE_FULL1 + 12 * (fr - 1)
                for i in range(W):
                    cs.append(alg.sub(s[i], w[base + i]))
                s = [w[base + i] for i in range(W)]
            s = mds([sbox(x) for x in s])
            r += 1
        for k in range(poseidon.PARTIAL_ROUNDS):
            s = [alg.add_const(x, poseidon.ROUND_CONSTANTS[r][i])
                 for i, x in enumerate(s)]
            cs.append(alg.sub(s[0], w[WIRE_PARTIAL + k]))
            s = mds([sbox(w[WIRE_PARTIAL + k])] + s[1:])
            r += 1
        for fr in range(4):
            s = [alg.add_const(x, poseidon.ROUND_CONSTANTS[r][i])
                 for i, x in enumerate(s)]
            base = WIRE_FULL2 + 12 * fr
            for i in range(W):
                cs.append(alg.sub(s[i], w[base + i]))
            s = mds([sbox(w[base + i]) for i in range(W)])
            r += 1
        for i in range(W):
            cs.append(alg.sub(w[WIRE_OUTPUT + i], s[i]))
        return cs

    # ---------------- stacked fast evaluation (prover) ----------------

    def eval_batch_fast(self, wires, constants, pi_hash):
        """wires: [num_wires, N] int64 -> [num_constraints, N]."""
        w = wires
        cs = []
        swap = w[WIRE_SWAP]
        cs.append(gl.mul(swap, gl.sub(swap, torch.ones_like(swap))))
        ins = w[WIRE_INPUT:WIRE_INPUT + 12]
        delta = w[WIRE_DELTA:WIRE_DELTA + 4]
        cs.extend(gl.sub(gl.mul(swap[None], gl.sub(ins[4:8], ins[:4])), delta))

        sbox = poseidon.sbox
        mds = poseidon.mds_cols
        s = _swapped_state(ins, delta)
        rc = poseidon.rc_tensor(w.device)
        r = 0
        for fr in range(4):
            s = gl.add(s, rc[r][:, None])
            if fr > 0:
                base = WIRE_FULL1 + 12 * (fr - 1)
                chk = w[base:base + 12]
                cs.extend(gl.sub(s, chk))
                s = chk
            s = mds(sbox(s))
            r += 1
        for k in range(poseidon.PARTIAL_ROUNDS):
            s = gl.add(s, rc[r][:, None])
            wk = w[WIRE_PARTIAL + k]
            cs.append(gl.sub(s[0], wk))
            s = mds(torch.cat([sbox(wk)[None], s[1:]], dim=0))
            r += 1
        for fr in range(4):
            s = gl.add(s, rc[r][:, None])
            base = WIRE_FULL2 + 12 * fr
            chk = w[base:base + 12]
            cs.extend(gl.sub(s, chk))
            s = mds(sbox(chk))
            r += 1
        cs.extend(gl.sub(w[WIRE_OUTPUT:WIRE_OUTPUT + 12], s))
        return torch.stack(cs, dim=0)

    # ---------------- witness ----------------

    def generators(self, row, constants):
        return [PoseidonGenerator(row)]

    def aux_fill(self, rows, wires):
        """Fill the 110 internal delta/s-box wires of every Poseidon row at
        once (wires: numpy uint64 [num_wires, n], updated in place), after
        the witness pass scattered inputs, swap and outputs: the plain
        permutation's rounds over the rows' states [12, R], on the CPU."""
        ins = gl.to_tensor(wires[WIRE_INPUT:WIRE_INPUT + W][:, rows], "cpu")
        swap = gl.to_tensor(wires[WIRE_SWAP][rows], "cpu")
        delta = gl.mul(swap[None], gl.sub(ins[4:8], ins[:4]))
        s = _swapped_state(ins, delta)
        rc = poseidon.rc_tensor("cpu")
        aux = [delta]
        r = 0
        for fr in range(poseidon.FULL_ROUNDS // 2):
            s = gl.add(s, rc[r][:, None])
            if fr > 0:
                aux.append(s)
            s = poseidon.mds_cols(poseidon.sbox(s))
            r += 1
        for _ in range(poseidon.PARTIAL_ROUNDS):
            s = gl.add(s, rc[r][:, None])
            aux.append(s[:1])
            s = poseidon.mds_cols(torch.cat([poseidon.sbox(s[:1]), s[1:]], dim=0))
            r += 1
        for _ in range(poseidon.FULL_ROUNDS // 2):
            s = gl.add(s, rc[r][:, None])
            aux.append(s)
            s = poseidon.mds_cols(poseidon.sbox(s))
            r += 1
        wires[WIRE_DELTA:WIRE_DELTA + NUM_AUX, rows] = gl.from_tensor(torch.cat(aux, dim=0))


def permute_row_outputs(ins: list[int], swap: int) -> list[int]:
    """Scalar gate semantics: state = (in[0..4] + delta, in[4..8] - delta,
    in[8..12]) with delta = swap * (in[4..8] - in[0..4]), then permute."""
    delta = [swap * (ins[4 + i] - ins[i]) % gl.P for i in range(4)]
    state = ([(ins[i] + delta[i]) % gl.P for i in range(4)] +
             [(ins[4 + i] - delta[i]) % gl.P for i in range(4)] + list(ins[8:]))
    return poseidon.permute_s(state)


class PoseidonGenerator(Generator):
    """Fills the 12 output wires from the 12 input wires + swap flag; the
    110 internal wires are filled later by the gate's batched `aux_fill`
    (they never feed dataflow)."""

    def __init__(self, row: int):
        from ..ir.builder import Wire
        self.row = row
        self.deps = [Wire(row, WIRE_INPUT + i) for i in range(W)] + \
                    [Wire(row, WIRE_SWAP)]
        self.outs = [Wire(row, c) for c in range(WIRE_OUTPUT, WIRE_OUTPUT + W)]

    def run(self, get):
        from ..ir.builder import Wire
        vals = [get(d) for d in self.deps]
        outs = permute_row_outputs(vals[:W], vals[W])
        return [(Wire(self.row, WIRE_OUTPUT + i), v) for i, v in enumerate(outs)]
