"""Static witness schedule ("tape"): the native witness engine.

Host copy of `plonky2_tpu/witness/tape.py`.  The dynamic scheduler
(witness.py) runs half a million Python generator closures per ECDSA
prove; this module replaces the hot path with a compile-once schedule.
The generator dependency DAG is static per circuit, so it is toposorted
ONCE (Kahn), each generator is lowered to a typed opcode where possible
(u32 arithmetic, Goldilocks mul-add, Poseidon rows, constant fills, base
decompositions, random access), and the whole tape executes inside one
C++ loop (native/witness_kernels.cpp `tape_run`) with Python escapes only
for the rare gadget hints (biguint/nonnative/GLV NamedGenerators).  The
wire-matrix scatter is precomputed as flat index arrays and becomes one
vectorized numpy assignment.  Field values stay numpy uint64 on the host.

The port has no fallback: a generator cycle raises the dynamic
scheduler's stall error, and a library that does not build raises.
"""

from __future__ import annotations

import ctypes
from collections import deque

import numpy as np

from .. import native
from ..field import gl
from ..gates.poseidon_gate import PoseidonGenerator
from ..hashes import poseidon
from ..ir.builder import Wire

(OP_PY, OP_U32MULADD, OP_U32ADDMANY, OP_U32SUB, OP_CMP, OP_ARITH,
 OP_CONSTS, OP_POSEIDON, OP_BASESUM, OP_RANDACC, OP_INTERLEAVE,
 OP_UNINTER, OP_ARITH_EXT, OP_MUL_EXT, OP_REDUCE, OP_REDUCE_EXT) = range(16)

_OPCODE_OF = {
    "u32muladd": OP_U32MULADD,
    "u32addmany": OP_U32ADDMANY,
    "u32sub": OP_U32SUB,
    "cmp": OP_CMP,
    "arith": OP_ARITH,
    "consts": OP_CONSTS,
    "basesum": OP_BASESUM,
    "randacc": OP_RANDACC,
    "interleave": OP_INTERLEAVE,
    "uninterleave": OP_UNINTER,
    "arith_ext": OP_ARITH_EXT,
    "mul_ext": OP_MUL_EXT,
    "reduce": OP_REDUCE,
    "reduce_ext": OP_REDUCE_EXT,
}
# op specs whose operands after the name go to the tape's constant pool
_POOLED = ("arith", "consts", "basesum", "uninterleave", "arith_ext", "mul_ext")


class Tape:
    __slots__ = ("code", "uoff", "upool", "dep_off", "dep_slots", "out_off",
                 "out_slots", "op_gen", "n_slots", "slot_of", "gens",
                 "scat_slots", "scat_cols", "scat_rows", "n_py")


def build_tape(pd, input_reps=frozenset()) -> Tape:
    """Toposort pd.generators and lower to opcode arrays.

    `input_reps` seeds the schedule with the prove-time input slots:
    gadgets like ECDSA connect an *input* to the end of a verification
    chain (e.g. r == P.x), which is a structural cycle that only the
    provided inputs break — so the order is specific to the input key
    set and get_tape caches one tape per set.  A genuine dependency cycle
    raises the dynamic scheduler's RuntimeError("witness generation
    stalled: ...")."""
    gens = pd.generators
    rep_of = pd.rep_of
    slot_of: dict = {}

    def slot(r):
        s = slot_of.get(r)
        if s is None:
            s = len(slot_of)
            slot_of[r] = s
        return s

    deps_s, outs_s = [], []
    producers: dict = {}
    for gi, g in enumerate(gens):
        deps_s.append([slot(rep_of(d)) for d in g.deps])
        os_ = [slot(rep_of(o)) for o in g.outs]
        outs_s.append(os_)
        for s in os_:
            producers.setdefault(s, []).append(gi)
    for t in pd.pi_targets:
        slot(rep_of(t))

    # Structural simulation of the dynamic scheduler (witness.py): a gen
    # is ready once every dep slot is ASSIGNED — by any one of possibly
    # several producers, or by the zero-default rule for slots no pending
    # gen can produce (prove-time inputs only assign EARLIER, so an order
    # valid with zero inputs stays valid for every input set).
    n = len(gens)
    n_slots = len(slot_of)
    assigned = bytearray(n_slots)
    for r in input_reps:
        s = slot_of.get(r)
        if s is not None:
            assigned[s] = 1              # provided at prove time
    producers_left = [len(producers.get(s, ())) for s in range(n_slots)]
    unmet = [0] * n
    waiters: dict = {}
    ready = deque()
    for gi in range(n):
        cnt = 0
        for s in deps_s[gi]:
            if assigned[s]:
                continue
            if producers_left[s]:
                waiters.setdefault(s, []).append(gi)
                cnt += 1
            else:
                assigned[s] = 1          # zero-default slot
        unmet[gi] = cnt
        if cnt == 0:
            ready.append(gi)
    order = []

    def assign(s):
        if assigned[s]:
            return
        assigned[s] = 1
        for gj in waiters.pop(s, ()):
            unmet[gj] -= 1
            if unmet[gj] == 0:
                ready.append(gj)

    while len(order) < n:
        while ready:
            gi = ready.popleft()
            order.append(gi)
            for s in outs_s[gi]:
                producers_left[s] -= 1
                assign(s)
        if len(order) == n:
            break
        progress = False
        for s in list(waiters):
            if not assigned[s] and producers_left[s] == 0:
                assign(s)
                progress = True
        if not progress:
            rep_at = {s: r for r, s in slot_of.items()}
            missing = [rep_at[s] for s in waiters if not assigned[s]][:10]
            blocked = sum(1 for u in unmet if u > 0)
            raise RuntimeError(
                f"witness generation stalled: {blocked} generators "
                f"blocked; sample missing deps: {missing}")

    code = np.zeros(n, dtype=np.int32)
    uoff = np.full(n, -1, dtype=np.int64)
    upool: list = []
    dep_off = np.zeros(n + 1, dtype=np.int32)
    out_off = np.zeros(n + 1, dtype=np.int32)
    dep_flat: list = []
    out_flat: list = []
    op_gen = np.zeros(n, dtype=np.int64)
    n_py = 0
    for k, gi in enumerate(order):
        g = gens[gi]
        op_gen[k] = gi
        dep_flat.extend(deps_s[gi])
        out_flat.extend(outs_s[gi])
        dep_off[k + 1] = len(dep_flat)
        out_off[k + 1] = len(out_flat)
        opspec = getattr(g, "op", None)
        if opspec is not None and opspec[0] in _OPCODE_OF:
            code[k] = _OPCODE_OF[opspec[0]]
            if opspec[0] in _POOLED:
                uoff[k] = len(upool)
                upool.extend(int(v) % gl.P for v in opspec[1:])
        elif isinstance(g, PoseidonGenerator):
            code[k] = OP_POSEIDON
        else:
            code[k] = OP_PY
            n_py += 1

    t = Tape()
    t.code = code
    t.uoff = uoff
    t.upool = np.asarray(upool or [0], dtype=np.uint64)
    t.dep_off = dep_off
    t.dep_slots = np.asarray(dep_flat or [0], dtype=np.int32)
    t.out_off = out_off
    t.out_slots = np.asarray(out_flat or [0], dtype=np.int32)
    t.op_gen = op_gen
    t.n_slots = len(slot_of)
    t.slot_of = slot_of
    t.gens = gens
    t.n_py = n_py

    # precomputed scatter: every Wire member of every slotted class
    ss, cc, rr = [], [], []
    for rep, s in slot_of.items():
        members = pd.class_wires.get(rep, ())
        if isinstance(rep, Wire) and rep not in members:
            ss.append(s); cc.append(rep.column); rr.append(rep.row)
        for w in members:
            ss.append(s); cc.append(w.column); rr.append(w.row)
    t.scat_slots = np.asarray(ss, dtype=np.int64)
    t.scat_cols = np.asarray(cc, dtype=np.int64)
    t.scat_rows = np.asarray(rr, dtype=np.int64)
    return t


def get_tape(pd, input_reps=frozenset()) -> Tape:
    """The tape of `pd` for this set of input representatives, built once."""
    tapes = getattr(pd, "_tapes", None)
    if tapes is None:
        tapes = pd._tapes = {}
    t = tapes.get(input_reps)
    if t is None:
        t = tapes[input_reps] = build_tape(pd, input_reps)
    return t


class TapeStore:
    """Witness value view over the executed tape (same read surface as
    witness.WitnessValues)."""

    def __init__(self, pd, tape, values, has, side):
        self._rep_of = pd.rep_of
        self._tape = tape
        self._values = values
        self._has = has
        self._side = side
        self._pd = pd

    def has(self, t) -> bool:
        r = self._rep_of(t)
        s = self._tape.slot_of.get(r)
        if s is not None:
            return bool(self._has[s])
        return r in self._side

    def get(self, t) -> int:
        r = self._rep_of(t)
        s = self._tape.slot_of.get(r)
        if s is not None and self._has[s]:
            return int(self._values[s])
        return self._side[r]

    def get_or_zero(self, t) -> int:
        r = self._rep_of(t)
        s = self._tape.slot_of.get(r)
        if s is not None:
            return int(self._values[s])
        return self._side.get(r, 0)

    def scatter(self, num_wires: int, n: int) -> np.ndarray:
        """The wire matrix [num_wires, n] uint64 in one vectorized fill;
        values with no slot (side values) are written after the slots."""
        t = self._tape
        wires = np.zeros((num_wires, n), dtype=np.uint64)
        wires[t.scat_cols, t.scat_rows] = self._values[t.scat_slots]
        for r, v in self._side.items():
            if isinstance(r, Wire):
                wires[r.column, r.row] = v
            for w in self._pd.class_wires.get(r, ()):
                wires[w.column, w.row] = v
        return wires


def generate_witness_tape(pd, inputs: dict) -> TapeStore:
    """Tape-path witness generation: inputs {target: int} -> TapeStore.
    A conflicting value raises ValueError, as in the dynamic scheduler."""
    if not poseidon.MDS_SMALL:
        raise RuntimeError("the witness tape's Poseidon rows need an MDS matrix with "
                           "entries < 2^20 (hashes/poseidon.py MDS_SMALL)")
    L = native.lib()
    rep_of = pd.rep_of
    tape = get_tape(pd, frozenset(rep_of(t) for t in inputs))

    values = np.zeros(tape.n_slots or 1, dtype=np.uint64)
    has = np.zeros(tape.n_slots or 1, dtype=np.uint8)
    side: dict = {}

    def put(r, v):
        v = v % gl.P
        s = tape.slot_of.get(r)
        if s is None:
            old = side.get(r)
            if old is not None and old != v:
                raise ValueError(f"conflicting witness value for {r}: "
                                 f"{old} vs {v}")
            side[r] = v
        else:
            if has[s] and int(values[s]) != v:
                raise ValueError(f"conflicting witness value for {r}: "
                                 f"{int(values[s])} vs {v}")
            values[s] = v
            has[s] = 1

    for t, v in inputs.items():
        put(rep_of(t), int(v))

    u64, i32, i64 = ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64
    rc = np.ascontiguousarray(poseidon.ROUND_CONSTANTS, dtype=np.uint64)
    mds = np.ascontiguousarray(poseidon.MDS, dtype=np.uint64)
    err = np.zeros(1, dtype=np.int64)
    head = (native.ptr(values, u64), native.ptr(has, ctypes.c_uint8),
            native.ptr(tape.code, i32), native.ptr(tape.uoff, i64),
            native.ptr(tape.upool, u64), native.ptr(tape.dep_off, i32),
            native.ptr(tape.dep_slots, i32), native.ptr(tape.out_off, i32),
            native.ptr(tape.out_slots, i32), len(tape.code))
    tail = (native.ptr(rc, u64), native.ptr(mds, u64), poseidon.FULL_ROUNDS // 2,
            poseidon.PARTIAL_ROUNDS, native.ptr(err, i64))

    store = TapeStore(pd, tape, values, has, side)
    get = store.get_or_zero          # PY escapes read unset deps as zero
    idx = 0
    while True:
        idx = L.tape_run(*head, idx, *tail)
        if idx == -1:
            break
        if idx == -2:
            raise ValueError(
                f"conflicting witness value at tape slot {int(err[0])}")
        g = tape.gens[int(tape.op_gen[idx])]
        for t, v in g.run(get):
            put(rep_of(t), int(v))
        idx += 1
    return store
