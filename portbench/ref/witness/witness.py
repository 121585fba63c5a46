"""Witness generation: dependency-scheduled hint execution.

Host copy of `plonky2_tpu/witness/witness.py`.  A generator is a host
object with explicit `deps`; generation runs an O(edges) dataflow
scheduler: each generator keeps an unmet-dependency counter, a per-target
waiter index wakes generators as values land, and a FIFO drains ready
work.  Gates with non-routed helper wires fill them afterwards in one
batched pass per gate type (`aux_fill`, see prove/prover.py).

The prover runs the static tape (witness/tape.py), which lowers most
generators to the opcode their `op` spec names; this scheduler is the
semantic reference that the tape is held against.
"""

from __future__ import annotations

from collections import deque

from ..field import gl


class Generator:
    """deps: targets that must be known before `run`; outs: targets this
    generator may assign (used to decide when a missing wire is simply
    unused and defaults to zero); run returns [(target, value)]."""

    deps: list
    outs: list = []

    def run(self, get):
        raise NotImplementedError


class LambdaGenerator(Generator):
    __slots__ = ("deps", "outs", "fn", "op")

    def __init__(self, deps, fn, outs=(), op=None):
        self.deps = deps
        self.outs = list(outs)
        self.fn = fn          # fn(values: list[int]) -> list[(target, value)]
        self.op = op          # optional tape opcode spec (witness/tape.py)

    def run(self, get):
        return self.fn([get(d) for d in self.deps])


def generate_witness(prover_data, inputs: dict) -> "WitnessValues":
    """inputs: {target: int}.  Returns the resolved witness store.

    Generators whose deps are all known sit in a FIFO; setting a target's
    equivalence class wakes every generator waiting on it.  When the queue
    drains with generators still blocked, unset wires that nothing pending
    can produce are unused gate slots and default to 0 (plonky2 semantics).
    """
    store = WitnessValues(prover_data.rep_of)
    rep_of = store._rep_of
    vals = store._vals

    gens = prover_data.generators
    unmet = [0] * len(gens)
    waiters: dict = {}
    ready = deque()
    for gi, g in enumerate(gens):
        n = 0
        for d in g.deps:
            r = rep_of(d)
            if r not in vals:
                waiters.setdefault(r, []).append(gi)
                n += 1
        unmet[gi] = n
        if n == 0:
            ready.append(gi)

    def _set(t, v):
        v = v % gl.P
        r = rep_of(t)
        old = vals.get(r)
        if old is not None:
            if old != v:
                raise ValueError(
                    f"conflicting witness value for {t}: {old} vs {v}")
            return
        vals[r] = v
        for gi in waiters.pop(r, ()):
            unmet[gi] -= 1
            if unmet[gi] == 0:
                ready.append(gi)

    for t, v in inputs.items():
        _set(t, int(v))

    get = store.get
    n_done = 0
    n_total = len(gens)
    while n_done < n_total:
        while ready:
            gi = ready.popleft()
            if unmet[gi] < 0:
                continue
            unmet[gi] = -1          # mark executed
            n_done += 1
            for t, v in gens[gi].run(get):
                _set(t, v)
        if n_done == n_total:
            break
        producible = {rep_of(t) for gi, g in enumerate(gens)
                      if unmet[gi] > 0 for t in g.outs}
        filled = False
        for r in list(waiters.keys()):
            if r not in producible and r not in vals:
                _set(r, 0)
                filled = True
        if not filled:
            missing = [r for r in waiters if r not in vals][:10]
            blocked = sum(1 for u in unmet if u > 0)
            raise RuntimeError(
                f"witness generation stalled: {blocked} generators "
                f"blocked; sample missing deps: {missing}")
    return store


class WitnessValues:
    def __init__(self, rep_of):
        self._rep_of = rep_of      # fn target -> canonical representative
        self._vals: dict = {}

    def has(self, t) -> bool:
        return self._rep_of(t) in self._vals

    def get(self, t) -> int:
        return self._vals[self._rep_of(t)]

    def set(self, t, v: int):
        v = v % gl.P
        r = self._rep_of(t)
        old = self._vals.get(r)
        if old is not None and old != v:
            raise ValueError(f"conflicting witness value for {t}: {old} vs {v}")
        self._vals[r] = v
