"""CircuitBuilder: the gadget handle (plonky2's `CircuitBuilder`).

Host copy of `plonky2_tpu/ir/builder.py`.  Targets are plain values —
`int` for virtual targets, `Wire(row, col)` for wire slots — tracked in
one union-find.  `build(device=...)` lowers everything to tensors
(selector/constant/sigma polynomials, the committed constants/sigmas
oracle) on that device, the card unless the caller asks for the CPU, plus
host tables for witness routing.

The port carries every gate of the JAX package: arithmetic, constant,
public-input, noop, Poseidon, Poseidon2, base-sum, comparison,
random-access, u32, exponentiation, the GF(p^2) gates, coset
interpolation and the lookup gates (the u32, biguint, nonnative, curve,
ECDSA and Keccak builder methods come from `gadgets/`; `add_lookup_table`
and `lookup` from `gates/lookup.py`, whose rows `build()` places first).
"""

from __future__ import annotations

from collections import namedtuple

from ..field import gl
from ..gates import (ArithmeticExtensionGate, ArithmeticGate, BaseSumGate,
                     ComparisonGate, ConstantGate, CosetInterpolationGate,
                     ExponentiationGate, MulExtensionGate, PoseidonGate,
                     RandomAccessGate, ReducingExtensionGate, ReducingGate)
from ..gates import lookup as lookup_gates
from ..hashes import poseidon
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..witness import NamedGenerator

Wire = namedtuple("Wire", ["row", "column"])


class CircuitBuilder:
    def __init__(self, config):
        self.config = config
        self.gate_instances: list = []       # [(gate, constants: list[int])]
        self.public_inputs: list = []
        self.custom_generators: list = []    # gadget hint generators
        self._num_virtual = 0
        self._parent: dict = {}              # DSU
        self._constant_cache: dict = {}
        self._slots: dict = {}               # (gate_key, consts) -> (row, used)
        self._const_slots: list = []         # open ConstantGate rows
        self._built = False

    # ---------------- targets & copy constraints ----------------

    def add_virtual_target(self) -> int:
        t = self._num_virtual
        self._num_virtual += 1
        return t

    def add_virtual_targets(self, n: int) -> list[int]:
        return [self.add_virtual_target() for _ in range(n)]

    def _find(self, x):
        """x's class representative, the same root as the JAX builder's.
        Every node on x's path is pointed at the root (the JAX builder's
        `x, p[x] = p[x], root` assigns x first, so it repoints only x's
        parent and leaves the chains that a long run of `connect` builds
        for the next call to walk again)."""
        p = self._parent
        root = x
        while root in p:
            root = p[root]
        while x != root:
            p[x], x = root, p[x]
        return root

    def connect(self, a, b):
        for t in (a, b):
            if isinstance(t, Wire) and t.column >= self.config.num_routed_wires:
                raise ValueError(f"cannot route non-routed wire {t}")
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[ra] = rb

    # ---------------- gate placement ----------------

    def add_gate(self, gate, constants=()) -> int:
        if self._built:
            raise RuntimeError("circuit already built")
        if gate.num_wires > self.config.num_wires:
            raise ValueError(f"{gate.key()} needs {gate.num_wires} wires > "
                             f"{self.config.num_wires}")
        row = len(self.gate_instances)
        self.gate_instances.append((gate, list(constants)))
        return row

    def num_gates(self) -> int:
        return len(self.gate_instances)

    # ---------------- constants ----------------

    def constant(self, c: int) -> int:
        c = c % gl.P
        if c in self._constant_cache:
            return self._constant_cache[c]
        for entry in self._const_slots:
            if entry["used"] < entry["n"]:
                row, slot = entry["row"], entry["used"]
                entry["used"] += 1
                self.gate_instances[row][1].append(c)
                break
        else:
            g = ConstantGate(num_consts=self.config.num_constants)
            row = self.add_gate(g, [])
            self.gate_instances[row][1].append(c)
            self._const_slots.append({"row": row, "n": g.num_consts, "used": 1})
            slot = 0
        t = self.add_virtual_target()
        self.connect(t, Wire(row, slot))
        self._constant_cache[c] = t
        return t

    def zero(self) -> int:
        return self.constant(0)

    def one(self) -> int:
        return self.constant(1)

    def two(self) -> int:
        return self.constant(2)

    def neg_one(self) -> int:
        return self.constant(gl.P - 1)

    # ---------------- arithmetic ops (slot-packed) ----------------

    def arithmetic(self, c0: int, c1: int, m0, m1, addend) -> int:
        """Returns target of c0*m0*m1 + c1*addend (one ArithmeticGate slot)."""
        c0, c1 = c0 % gl.P, c1 % gl.P
        gate = ArithmeticGate.from_config(self.config)
        key = (gate.key(), c0, c1)
        row, slot = self._claim_slot(key, gate, [c0, c1], gate.num_ops)
        w0, w1, w2, w3 = ArithmeticGate.wires_op(slot)
        self.connect(m0, Wire(row, w0))
        self.connect(m1, Wire(row, w1))
        self.connect(addend, Wire(row, w2))
        out = self.add_virtual_target()
        self.connect(out, Wire(row, w3))
        return out

    def _claim_slot(self, key, gate, constants, max_slots):
        entry = self._slots.get(key)
        if entry is None or entry[1] >= max_slots:
            row = self.add_gate(gate, constants)
            self._slots[key] = (row, 1)
            return row, 0
        row, used = entry
        self._slots[key] = (row, used + 1)
        return row, used

    def add(self, a, b):
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a, b):
        return self.arithmetic(1, gl.P - 1, a, self.one(), b)

    def mul(self, a, b):
        return self.arithmetic(1, 0, a, b, self.zero())

    def mul_const(self, c, a):
        return self.arithmetic(c, 0, a, self.one(), self.zero())

    def mul_add(self, a, b, c):
        """a*b + c"""
        return self.arithmetic(1, 1, a, b, c)

    def add_const(self, a, c):
        return self.arithmetic(1, c, a, self.one(), self.one())

    def add_many(self, xs):
        acc = self.zero()
        for x in xs:
            acc = self.add(acc, x)
        return acc

    def assert_zero(self, t):
        self.connect(t, self.zero())

    def assert_one(self, t):
        self.connect(t, self.one())

    def assert_bool(self, t):
        # t*t == t forces t in {0, 1}
        self.connect(self.mul(t, t), t)

    def select(self, b, x, y):
        """b ? x : y   (b must be boolean)."""
        return self.mul_add(b, self.sub(x, y), y)

    def not_(self, b):
        return self.sub(self.one(), b)

    def and_(self, a, b):
        return self.mul(a, b)

    def or_(self, a, b):
        return self.sub(self.add(a, b), self.mul(a, b))

    def is_equal(self, a, b):
        """Boolean target: a == b.  Hint m = (a-b)^-1 (or 0), verify
        eq = 1 - (a-b)*m with (a-b)*eq == 0 (plonky2's `is_equal`)."""
        diff = self.sub(a, b)
        m = self.add_virtual_target()
        self.add_simple_generator(NamedGenerator("inv_or_zero", {}, [diff], [m]))
        eq = self.not_(self.mul(diff, m))
        self.assert_zero(self.mul(diff, eq))
        return eq

    def le_sum(self, bits: list):
        """Recombine little-endian bits into a target (pure arithmetic)."""
        acc = self.zero()
        for b in reversed(bits):
            acc = self.mul_add(self.two(), acc, b)
        return acc

    # ---------------- decomposition ----------------

    def split_le(self, x, num_bits: int) -> list:
        """Little-endian bit decomposition (bits are range-constrained)."""
        return self.split_le_base(2, x, num_bits)

    def split_le_base(self, base: int, x, num_limbs: int) -> list:
        gate = BaseSumGate(base, num_limbs)
        row = self.add_gate(gate, [])
        self.connect(x, Wire(row, gate.WIRE_SUM))
        limbs = []
        for i in range(num_limbs):
            t = self.add_virtual_target()
            self.connect(t, Wire(row, gate.wire_limb(i)))
            limbs.append(t)
        return limbs

    def le_compare(self, a, b, num_bits: int = 32):
        """Boolean target (a <= b) through one ComparisonGate; the caller
        guarantees a, b < 2^num_bits."""
        gate = ComparisonGate(num_bits)
        row = self.add_gate(gate, [])
        self.connect(a, Wire(row, gate.WIRE_A))
        self.connect(b, Wire(row, gate.WIRE_B))
        out = self.add_virtual_target()
        self.connect(out, Wire(row, gate.WIRE_RESULT))
        return out

    def random_access(self, index, items: list):
        """items[index], constrained through one RandomAccessGate copy.
        Pads the list to a power of two with its last item; copies are
        slot-packed per `bits` variant."""
        n = len(items)
        if n < 1:
            raise ValueError("random_access needs at least one item")
        if n == 1:
            return items[0]
        bits = (n - 1).bit_length()
        items = list(items) + [items[-1]] * ((1 << bits) - n)
        gate = RandomAccessGate.from_config(self.config, bits)
        row, slot = self._claim_slot((gate.key(),), gate, [], gate.num_copies)
        ws = gate.wires_copy(slot)
        self.connect(index, Wire(row, ws["index"]))
        for i, it in enumerate(items):
            self.connect(it, Wire(row, ws["items"] + i))
        out = self.add_virtual_target()
        self.connect(out, Wire(row, ws["claimed"]))
        return out

    def exp_from_bits(self, base, bits: list):
        """base ^ sum(bits[i] * 2^i) through one ExponentiationGate (bits
        must be boolean; the gate re-checks them)."""
        gate = ExponentiationGate(len(bits))
        row = self.add_gate(gate, [])
        self.connect(base, Wire(row, gate.WIRE_BASE))
        for i, b in enumerate(bits):
            self.connect(b, Wire(row, gate.wire_bit(i)))
        out = self.add_virtual_target()
        self.connect(out, Wire(row, gate.wire_output))
        return out

    def exp_u64(self, base, exponent, num_bits: int = 64):
        """base ^ exponent for a target exponent of known bit width."""
        return self.exp_from_bits(base, self.split_le(exponent, num_bits))

    # ---------------- lookups (gates/lookup.py) ----------------

    def add_lookup_table(self, pairs: list) -> int:
        return lookup_gates.add_lookup_table(self, pairs)

    def lookup(self, x, table_id: int):
        return lookup_gates.lookup(self, x, table_id)

    # ---------------- extension-field ops (GF(p^2), field/ext.py) -------
    # An extension target is a (c0, c1) tuple of base targets (plonky2's
    # ExtensionTarget).

    def add_virtual_extension_target(self):
        return (self.add_virtual_target(), self.add_virtual_target())

    def constant_extension(self, c):
        c0, c1 = c if isinstance(c, tuple) else (c, 0)
        return (self.constant(c0), self.constant(c1))

    def zero_extension(self):
        return self.constant_extension((0, 0))

    def one_extension(self):
        return self.constant_extension((1, 0))

    def connect_extension(self, a, b):
        self.connect(a[0], b[0])
        self.connect(a[1], b[1])

    def arithmetic_extension(self, c0: int, c1: int, m0, m1, addend):
        """c0*m0*m1 + c1*addend over GF(p^2); one ArithmeticExtensionGate
        slot (constants per row, packed like the base `arithmetic`)."""
        c0, c1 = c0 % gl.P, c1 % gl.P
        gate = ArithmeticExtensionGate.from_config(self.config)
        key = (gate.key(), c0, c1)
        row, slot = self._claim_slot(key, gate, [c0, c1], gate.num_ops)
        ws = gate.wires_op(slot)
        for name, t in (("m0", m0), ("m1", m1), ("addend", addend)):
            self.connect(t[0], Wire(row, ws[name]))
            self.connect(t[1], Wire(row, ws[name] + 1))
        out = self.add_virtual_extension_target()
        self.connect(out[0], Wire(row, ws["out"]))
        self.connect(out[1], Wire(row, ws["out"] + 1))
        return out

    def mul_extension(self, a, b):
        gate = MulExtensionGate.from_config(self.config)
        key = (gate.key(), 1)
        row, slot = self._claim_slot(key, gate, [1], gate.num_ops)
        ws = gate.wires_op(slot)
        for name, t in (("m0", a), ("m1", b)):
            self.connect(t[0], Wire(row, ws[name]))
            self.connect(t[1], Wire(row, ws[name] + 1))
        out = self.add_virtual_extension_target()
        self.connect(out[0], Wire(row, ws["out"]))
        self.connect(out[1], Wire(row, ws["out"] + 1))
        return out

    def add_extension(self, a, b):
        return self.arithmetic_extension(1, 1, a, self.one_extension(), b)

    def sub_extension(self, a, b):
        return self.arithmetic_extension(1, gl.P - 1, a, self.one_extension(), b)

    def mul_add_extension(self, a, b, c):
        return self.arithmetic_extension(1, 1, a, b, c)

    def scalar_mul_ext(self, s: int, a):
        return self.arithmetic_extension(s, 0, a, self.one_extension(),
                                         self.zero_extension())

    def _reduce_ext(self, alpha, terms, gate_cls, max_coeffs, to_ext):
        acc = self.zero_extension()
        for start in range(0, len(terms), max_coeffs):
            chunk = terms[start:start + max_coeffs]
            gate = gate_cls(len(chunk))
            row = self.add_gate(gate, [])
            self.connect(alpha[0], Wire(row, gate.WIRE_ALPHA))
            self.connect(alpha[1], Wire(row, gate.WIRE_ALPHA + 1))
            self.connect(acc[0], Wire(row, gate.WIRE_OLD_ACC))
            self.connect(acc[1], Wire(row, gate.WIRE_OLD_ACC + 1))
            for i, t in enumerate(chunk):
                if to_ext:
                    self.connect(t[0], Wire(row, gate.WIRE_COEFFS + 2 * i))
                    self.connect(t[1], Wire(row, gate.WIRE_COEFFS + 2 * i + 1))
                else:
                    self.connect(t, Wire(row, gate.WIRE_COEFFS + i))
            acc = self.add_virtual_extension_target()
            self.connect(acc[0], Wire(row, gate.WIRE_OUTPUT))
            self.connect(acc[1], Wire(row, gate.WIRE_OUTPUT + 1))
        return acc

    def reduce_with_powers_ext(self, alpha, terms: list):
        """sum_i terms[i] * alpha^(n-1-i) for base-field targets `terms`
        (Horner over ReducingGate rows)."""
        return self._reduce_ext(alpha, list(terms), ReducingGate,
                                ReducingGate.max_coeffs(self.config), False)

    def interpolate_coset(self, subgroup_bits: int, shift, values: list, z):
        """Evaluate, at extension target `z`, the interpolant of the
        extension targets `values` given on the coset shift*H with
        |H| = 2^subgroup_bits and values[i] at shift * g^i (one
        CosetInterpolationGate: the recursive FRI fold check).

        PRECONDITION: `shift` must be nonzero: the gate's quotient-hint
        constraint `2*s*g^i*w == a-b` is vacuous at s == 0.  The FRI use
        derives shift as a power of the (nonzero) domain generator times
        the coset shift, which satisfies this by construction."""
        gate = CosetInterpolationGate(subgroup_bits)
        if len(values) != gate.n_points:
            raise ValueError(f"interpolate_coset takes {gate.n_points} values, "
                             f"got {len(values)}")
        row = self.add_gate(gate, [])
        self.connect(shift, Wire(row, gate.WIRE_SHIFT))
        for i, t in enumerate(values):
            self.connect(t[0], Wire(row, gate.wire_values + 2 * i))
            self.connect(t[1], Wire(row, gate.wire_values + 2 * i + 1))
        self.connect(z[0], Wire(row, gate.wire_z))
        self.connect(z[1], Wire(row, gate.wire_z + 1))
        out = self.add_virtual_extension_target()
        self.connect(out[0], Wire(row, gate.wire_output))
        self.connect(out[1], Wire(row, gate.wire_output + 1))
        return out

    def reduce_with_powers_ext_circuit(self, alpha, terms: list):
        """Horner fold of extension targets by alpha (plonky2's
        `reduce_with_powers_ext_circuit`)."""
        return self._reduce_ext(alpha, list(terms), ReducingExtensionGate,
                                ReducingExtensionGate.max_coeffs(self.config),
                                True)

    # ---------------- public inputs ----------------

    def register_public_input(self, t):
        self.public_inputs.append(t)

    def register_public_inputs(self, ts):
        self.public_inputs.extend(ts)

    # ---------------- hashing ----------------

    def permute_swapped(self, inputs: list, swap) -> list:
        """One Poseidon(2)Gate, per config.algebraic_hasher, taking 12
        inputs + swap bool -> 12 outputs.  Both gates share a wire layout."""
        from ..gates import Poseidon2Gate, poseidon_gate as pg
        if len(inputs) != poseidon.WIDTH:
            raise ValueError(f"permute takes {poseidon.WIDTH} inputs")
        gate = Poseidon2Gate() if self.config.algebraic_hasher == "poseidon2" \
            else PoseidonGate()
        row = self.add_gate(gate, [])
        for i, t in enumerate(inputs):
            self.connect(t, Wire(row, pg.WIRE_INPUT + i))
        self.connect(swap, Wire(row, pg.WIRE_SWAP))
        outs = []
        for i in range(poseidon.WIDTH):
            t = self.add_virtual_target()
            self.connect(t, Wire(row, pg.WIRE_OUTPUT + i))
            outs.append(t)
        return outs

    def permute(self, inputs: list) -> list:
        return self.permute_swapped(inputs, self.zero())

    def hash_n_to_m_no_pad(self, inputs: list, num_outputs: int) -> list:
        state = [self.zero()] * poseidon.WIDTH
        for i in range(0, len(inputs), poseidon.RATE):
            chunk = inputs[i:i + poseidon.RATE]
            state = list(chunk) + state[len(chunk):]
            state = self.permute(state)
        outputs = []
        while True:
            outputs.extend(state[:poseidon.RATE])
            if len(outputs) >= num_outputs:
                return outputs[:num_outputs]
            state = self.permute(state)

    def hash_n_to_hash_no_pad(self, inputs: list) -> list:
        return self.hash_n_to_m_no_pad(inputs, poseidon.HASH_OUT)

    def two_to_one(self, x: list, y: list) -> list:
        z = [self.zero()] * (poseidon.WIDTH - 2 * poseidon.HASH_OUT)
        return self.permute(list(x) + list(y) + z)[:poseidon.HASH_OUT]

    # ---------------- generators ----------------

    def add_simple_generator(self, gen):
        self.custom_generators.append(gen)

    # ---------------- build ----------------

    def build(self, device=DEFAULT_DEVICE):
        """Compile the circuit; its tensors live on `device`: the card unless
        the caller asks for the CPU (no card: raises before any work)."""
        from ..prove.compile import compile_circuit
        resolve_device(device)          # no card: raise before any work
        lookup_gates.finalize_lookup_tables(self)   # lookup rows + hints
        data = compile_circuit(self, device)
        self._built = True
        return data
