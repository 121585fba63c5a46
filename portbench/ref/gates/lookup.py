"""Lookup gates, their builder functions and the lookup structure of a
compiled circuit.

Counterpart of `plonky2_tpu/gates/lookup.py`.  The argument is logUp with
per-slot inverse helper polynomials: for random challenges (lam, gam)
drawn after the wire commitment,

    sum_{lookup slots} 1/(gam - (x + lam*y))
  = sum_{table slots}  m/(gam - (t_in + lam*t_out))

enforced through committed helper polys A_s = mu_s/(gam - combo_s) and an
exclusive running-sum poly S (`prove/prover.py` `lookup_phase`): one
batched inverse and one scan over the whole trace.

Both gates share one wire layout, so the argument reads fixed columns:
slot s occupies wires (3s, 3s+1, 3s+2) = (x, y, m).

* `LookupGate`: (x, y) is the looked-up pair (routed); the constraint per
  slot is m + 1 = 0 (each slot contributes -1/(gam - combo)).  Unused
  slots are padded with the table's first pair, a real table entry
  counted in the multiplicities.
* `LookupTableGate`: (x, y) are bound to the table entry constants
  (x - c_{2s} = 0, y - c_{2s+1} = 0); m is the multiplicity, filled by one
  `lookup_mults` hint per table that counts every lookup.
"""

from __future__ import annotations

from ..field import gl
from ..witness import LambdaGenerator, NamedGenerator
from .base import Gate


class LookupGate(Gate):
    """num_slots looked-up (x, y) pairs per row."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots

    def key(self) -> str:
        return f"Lookup(num_slots={self.num_slots})"

    @property
    def num_wires(self):
        return 3 * self.num_slots

    @property
    def degree(self):
        return 1

    @property
    def num_constraints(self):
        return self.num_slots

    def eval(self, vars, alg):
        # m_s = -1 on every slot
        return [alg.add_const(vars.local_wires[3 * s + 2], 1)
                for s in range(self.num_slots)]

    def generators(self, row, constants):
        from ..ir.builder import Wire
        ns = self.num_slots

        def fn(vals, row=row, ns=ns):
            return [(Wire(row, 3 * s + 2), gl.P - 1) for s in range(ns)]

        return [LambdaGenerator([], fn,
                                outs=[Wire(row, 3 * s + 2) for s in range(ns)],
                                op=("consts",) + (gl.P - 1,) * ns)]


class LookupTableGate(Gate):
    """num_slots table entries per row; the entries are the gate constants
    (2 per slot), the multiplicities the m wires."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots

    def key(self) -> str:
        return f"LookupTable(num_slots={self.num_slots})"

    @property
    def num_wires(self):
        return 3 * self.num_slots

    @property
    def num_constants(self):
        return 2 * self.num_slots

    @property
    def degree(self):
        return 1

    @property
    def num_constraints(self):
        return 2 * self.num_slots

    def eval(self, vars, alg):
        cs = []
        for s in range(self.num_slots):
            cs.append(alg.sub(vars.local_wires[3 * s],
                              vars.local_constants[2 * s]))
            cs.append(alg.sub(vars.local_wires[3 * s + 1],
                              vars.local_constants[2 * s + 1]))
        return cs

    def generators(self, row, constants):
        from ..ir.builder import Wire

        # the x and y wires take the table entries; m comes from the
        # table's lookup_mults hint
        def fn(vals, row=row, consts=tuple(constants)):
            out = []
            for s in range(len(consts) // 2):
                out.append((Wire(row, 3 * s), consts[2 * s]))
                out.append((Wire(row, 3 * s + 1), consts[2 * s + 1]))
            return out

        outs = [Wire(row, 3 * s + j)
                for s in range(len(constants) // 2) for j in (0, 1)]
        return [LambdaGenerator([], fn, outs=outs,
                                op=("consts",) + tuple(constants))]


# ------------------------------------------------------------------
# builder functions (CircuitBuilder.add_lookup_table / lookup / build)
# ------------------------------------------------------------------

LOOKUP_SLOTS = 6        # 18 wires a row, within the routed wires


def add_lookup_table(self, pairs: list) -> int:
    """Register a lookup table, a list of (input, output) pairs with
    distinct inputs; returns its id for `lookup`.  Its gates and its
    multiplicity hint are placed at build time (finalize_lookup_tables)."""
    pairs = [(int(a) % gl.P, int(b) % gl.P) for a, b in pairs]
    if len({a for a, _ in pairs}) != len(pairs):
        raise ValueError("duplicate table inputs")
    if not hasattr(self, "_lookup_tables"):
        self._lookup_tables = []
        self._lookup_uses = []
    self._lookup_tables.append(pairs)
    self._lookup_uses.append([])
    return len(self._lookup_tables) - 1


def lookup(self, x, table_id: int):
    """In-circuit table lookup: returns y with (x, y) constrained to be a
    pair of the table (the witness hint computes y = table[x])."""
    y = self.add_virtual_target()
    self._lookup_uses[table_id].append((x, y))
    return y


def finalize_lookup_tables(self) -> None:
    """Called by build(): place the Lookup and LookupTable rows and the
    hints of every registered table.  The order of events fixes the gate
    placement, so it is the JAX package's: the per-use `lookup_out` hints,
    the pad slots' constants, the Lookup rows, the table rows, then one
    `lookup_mults` hint."""
    from ..ir.builder import Wire

    if not getattr(self, "_lookup_tables", None):
        return
    for pairs, uses in zip(self._lookup_tables, self._lookup_uses):
        table_params = {"table": [[a, b] for a, b in pairs]}
        for x, y in uses:
            self.add_simple_generator(NamedGenerator(
                "lookup_out", table_params, [x], [y]))
        # lookup rows: k slots a row, padded with the table's first pair
        k = LOOKUP_SLOTS
        pad_x, pad_y = pairs[0]
        slots = list(uses)
        for _ in range((-len(slots)) % k):
            slots.append((self.constant(pad_x), self.constant(pad_y)))
        lookup_inputs = [x for x, _ in slots]
        for base in range(0, len(slots), k):
            row = self.add_gate(LookupGate(k), [])
            for s, (x, y) in enumerate(slots[base:base + k]):
                self.connect(x, Wire(row, 3 * s))
                self.connect(y, Wire(row, 3 * s + 1))
        # table rows: k entries a row, padded by repeating the last entry
        # (the multiplicity hint gives the full count to the first one)
        entries = list(pairs)
        entries += [pairs[-1]] * ((-len(entries)) % k)
        m_wires = []
        for base in range(0, len(entries), k):
            consts = []
            for a, b in entries[base:base + k]:
                consts.extend((a, b))
            row = self.add_gate(LookupTableGate(k), consts)
            m_wires.extend(Wire(row, 3 * s + 2) for s in range(k))
        self.add_simple_generator(NamedGenerator(
            "lookup_mults", {"table_in": [a for a, _ in entries]},
            lookup_inputs, m_wires))


# ------------------------------------------------------------------
# prover and verifier structure
# ------------------------------------------------------------------

def _filter_const(sel_info, gi: int) -> int:
    """The constant value the selector filter takes on gate gi's own
    rows: prod_{other in group}(other - gi) * (unused - gi)."""
    grp = sel_info.groups[sel_info.gate_group[gi]]
    kappa = 1
    for other in grp:
        if other != gi:
            kappa = kappa * ((other - gi) % gl.P) % gl.P
    if len(sel_info.groups) > 1:
        kappa = kappa * ((sel_info.unused - gi) % gl.P) % gl.P
    return kappa


def lookup_info(common):
    """Lookup structure of a compiled circuit: the gate indices, the slot
    count and each gate's inverse filter constant; {"has": False, "k": 0}
    when the circuit has no lookups.

    The inverse constant is kappa^-1, kappa being the value the selector
    filter takes on the gate's own rows: the logUp terms use the
    normalized filter filt_gi(x)/kappa (1 on the gate's rows, 0 elsewhere
    on H), so that both sides of the multiset equation carry unit
    weights."""
    lk = [(gi, g.num_slots) for gi, g in enumerate(common.gates)
          if isinstance(g, LookupGate)]
    tb = [(gi, g.num_slots) for gi, g in enumerate(common.gates)
          if isinstance(g, LookupTableGate)]
    if not lk and not tb:
        return {"has": False, "k": 0}
    k = max(ns for _, ns in lk + tb)
    sel = common.selector_info

    def kinv(gi):
        return pow(_filter_const(sel, gi), gl.P - 2, gl.P)

    return {
        "has": True,
        "k": k,
        "lk": [(gi, ns, kinv(gi)) for gi, ns in lk],
        "tb": [(gi, ns, kinv(gi)) for gi, ns in tb],
        # the zs oracle's rows: per challenge [A_0 .. A_{k-1}, S], after
        # the Z and partial-product rows
        "polys_per_challenge": k + 1,
    }
