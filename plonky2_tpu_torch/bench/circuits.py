"""Self-sizing benchmark circuits (configs 1, 2 and 3 of BASELINE.md).

Counterpart of `build_poseidon_chain`, `build_u32_mix` and
`build_smt_process` in `plonky2_tpu/bench/circuits.py`: each circuit
repeats its unit until `num_gates()` reaches the target; the compiler pads
to the next power of two.  Configs 4 and 5 need gates and gadgets that are
not ported yet.
"""

from __future__ import annotations

import random

from ..field import gl
from ..ir import CircuitBuilder, CircuitConfig


def _target_rows(degree_bits: int, margin: int) -> int:
    return (1 << degree_bits) - margin


def _fill(b: CircuitBuilder, add_unit, limit: int) -> int:
    """Add units until one more would cross `limit` rows; returns the count.

    The first unit is measured to learn the per-unit gate cost (slot
    packing makes later units slightly cheaper, so this is conservative)."""
    g0 = b.num_gates()
    add_unit()
    unit = max(1, b.num_gates() - g0)
    count = 1
    while b.num_gates() + unit <= limit:
        add_unit()
        count += 1
    return count


def build_poseidon_chain(degree_bits: int = 12, config: CircuitConfig | None = None):
    """Config 1: a Poseidon two_to_one chain sized to degree 2^degree_bits,
    under `standard_recursion_config` unless `config` says otherwise.
    Returns (builder, inputs, meta)."""
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    xs = [b.add_virtual_target() for _ in range(4)]
    cur = xs
    target = _target_rows(degree_bits, 8)
    while b.num_gates() < target:
        cur = b.two_to_one(cur, cur)
    for t in cur:
        b.register_public_input(t)
    inputs = {xs[i]: i + 1 for i in range(4)}
    return b, inputs, {"name": "poseidon_chain", "degree_bits": degree_bits}


def build_u32_mix(degree_bits: int = 13, config: CircuitConfig | None = None):
    """Config 2: u32 mul/add/xor/sub/compare with range checks, sized to
    degree 2^degree_bits, under `standard_recursion_config` unless `config`
    says otherwise; inputs from the JAX package's seed.  Returns (builder,
    inputs, meta)."""
    from .. import gadgets  # noqa: F401  (attaches the u32 builder API)

    rng = random.Random(0x32BE7C4)
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    x = b.add_virtual_u32_target()
    y = b.add_virtual_u32_target()
    acc = x
    target = _target_rows(degree_bits, 16)
    while b.num_gates() < target:
        lo, hi = b.mul_u32(acc, y)
        s, _carry = b.add_u32(lo, hi)
        xor = b.xor_u32(s, acc)
        d, _borrow = b.sub_u32(xor, y, b.zero_u32())
        _lt = b.is_less_than_u32(d, y)
        acc = d
    b.register_public_input(acc.target)
    inputs = {x.target: rng.randrange(1 << 32), y.target: rng.randrange(1 << 32)}
    return b, inputs, {"name": "u32_mix", "degree_bits": degree_bits}


def build_smt_process(degree_bits: int = 14, n_levels: int = 32,
                      config: CircuitConfig | None = None):
    """Config 3: chained SMT process proofs at depth `n_levels` (the
    reference's src/smt process circuits), sized to degree 2^degree_bits,
    under `standard_recursion_config` unless `config` says otherwise.  The
    witnesses come from the native tree: an insert / update / insert mix
    drawn from a fixed seed.  Returns (builder, inputs, meta)."""
    from ..gadgets.smt import SparseMerkleProcessProofTarget, verify_smt_transition
    from ..smt import SparseMerkleTree

    rng = random.Random(0x517BE7C4)

    def rand_hash():
        return tuple(rng.randrange(gl.P) for _ in range(4))

    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    targets = []

    def add_unit():
        t = SparseMerkleProcessProofTarget.add_virtual_to(b, n_levels)
        if targets:
            verify_smt_transition(b, t.fnc, targets[-1].new_root, t.old_root)
        targets.append(t)

    _fill(b, add_unit, _target_rows(degree_bits, 16))
    for e in targets[0].old_root + targets[-1].new_root:
        b.register_public_input(e)

    tree = SparseMerkleTree()
    keys = [rand_hash() for _ in range(max(4, len(targets)))]
    proofs = []
    for i in range(len(targets)):
        op = i % 3
        if op == 0:
            proofs.append(tree.insert(keys[i], rand_hash()))
        elif op == 1:
            proofs.append(tree.update(keys[i - 1], rand_hash()))
        else:
            proofs.append(tree.insert(rand_hash(), rand_hash()))
    inputs: dict = {}
    for t, pr in zip(targets, proofs):
        t.set_witness(inputs, pr)
    return b, inputs, {"name": "smt_process", "degree_bits": degree_bits,
                       "num_proofs": len(targets)}
