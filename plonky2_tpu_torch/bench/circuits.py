"""Benchmark circuits (configs 1-5 of BASELINE.md).

Counterpart of `build_poseidon_chain`, `build_u32_mix`, `build_smt_process`
and `build_ecdsa` in `plonky2_tpu/bench/circuits.py`.  Configs 1-3 size
themselves: each repeats its unit until `num_gates()` reaches the target,
and the compiler pads to the next power of two.  Config 4 has its natural
size (one signature: 55,421 gates, 2^16 rows); `build_small_ecc` is a
2^9-row piece of it for a CPU prove.  Config 5 (`build_aggregation`)
proves four zkDSA signatures and builds the 2^13-row circuit that
verifies all four in-circuit.
"""

from __future__ import annotations

import random

from ..field import gl
from ..ir import CircuitBuilder, CircuitConfig
from ..utils.device import DEFAULT_DEVICE
from ..utils.timing import timed_span


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


def build_ecdsa(batch: int = 1, config: CircuitConfig | None = None):
    """Config 4: `batch` secp256k1 ECDSA verifications (the reference's
    `ecdsa/gadgets/ecdsa.rs` `verify_message_circuit`), under
    `standard_ecc_config` unless `config` says otherwise.  The key, message
    and signature of each come from the JAX package's seed, in its draw
    order.  Returns (builder, inputs, meta)."""
    from .. import gadgets  # noqa: F401  (attaches the ECDSA builder API)
    from ..field import secp
    from ..gadgets.biguint import set_biguint_target
    from ..gadgets.ecdsa import ECDSAPublicKeyTarget

    rng = random.Random(0xECD5ABE7)
    b = CircuitBuilder(config or CircuitConfig.standard_ecc_config())
    triples = []
    for _ in range(batch):
        msg = b.add_virtual_nonnative_target(secp.N)
        sig = b.add_virtual_ecdsa_signature_target()
        pk = ECDSAPublicKeyTarget(b.add_virtual_affine_point_target())
        b.verify_message_circuit(msg, sig, pk)
        triples.append((msg, sig, pk))

    inputs: dict = {}
    for msg, sig, pk in triples:
        sk = rng.randrange(1, secp.N)
        pk_pt = secp.mul(secp.G, sk)
        h = rng.randrange(secp.N)
        r, s = secp.sign(h, sk, rng.randrange(1, secp.N))
        set_biguint_target(inputs, msg.value, h)
        set_biguint_target(inputs, sig.r.value, r)
        set_biguint_target(inputs, sig.s.value, s)
        set_biguint_target(inputs, pk.point.x.value, pk_pt.x)
        set_biguint_target(inputs, pk.point.y.value, pk_pt.y)
    return b, inputs, {"name": "ecdsa_verify", "batch": batch}


def build_small_ecc():
    """Config 4's building blocks at 2^9 rows, under `test_config`:
    secp256k1 `curve_add(p1, p2)`, `curve_double(p1)`, a RandomAccessGate
    select of one of [p1, p2, p1 + p2, 2 p1], and the GLV split of a
    scalar k.  The public inputs are the limbs of p1 + p2, 2 p1 and the
    selected point, then k1, k2 and their sign bits; p1, p2, the index and
    k come from a fixed seed.  Returns (builder, inputs, meta)."""
    from .. import gadgets  # noqa: F401  (attaches the curve builder API)
    from ..field import secp
    from ..gadgets.biguint import set_biguint_target

    rng = random.Random(0xECC5A11)
    b = CircuitBuilder(CircuitConfig.test_config())
    p1 = b.add_virtual_affine_point_target()
    p2 = b.add_virtual_affine_point_target()
    s = b.curve_add(p1, p2)
    d = b.curve_double(p1)
    index = b.add_virtual_target()
    sel = b.random_access_curve_points(index, [p1, p2, s, d])
    k = b.add_virtual_nonnative_target(secp.N)
    k1, k2, k1_neg, k2_neg = b.decompose_secp256k1_scalar(k)
    for pt in (s, d, sel):
        for c in (pt.x, pt.y):
            b.register_public_inputs([t.target for t in c.value.limbs])
    for c in (k1, k2):
        b.register_public_inputs([t.target for t in c.value.limbs])
    b.register_public_inputs([k1_neg, k2_neg])

    pt1 = secp.mul(secp.G, rng.randrange(1, secp.N))
    pt2 = secp.mul(secp.G, rng.randrange(1, secp.N))
    inputs: dict = {index: rng.randrange(4)}
    for tgt, pt in ((p1, pt1), (p2, pt2)):
        set_biguint_target(inputs, tgt.x.value, pt.x)
        set_biguint_target(inputs, tgt.y.value, pt.y)
    set_biguint_target(inputs, k.value, rng.randrange(secp.N))
    return b, inputs, {"name": "small_ecc"}


AGGREGATION_SEED = 0xA66BE7C4


def aggregation_draws(rng, num_proofs: int) -> list:
    """(private key, message) of each inner proof, drawn from `rng` in the
    JAX package's order: each proof's key, then its message."""
    draws = []
    for _ in range(num_proofs):
        key = tuple(rng.randrange(gl.P) for _ in range(4))
        msg = tuple(rng.randrange(gl.P) for _ in range(4))
        draws.append((key, msg))
    return draws


def aggregation_steps(rng, num_proofs: int = 4, device=DEFAULT_DEVICE):
    """`build_aggregation`'s make() up to the outer build: the zkDSA
    circuit under test_config built on `device`; for each proof a key and
    a message drawn from `rng`, the proof made and verified; then the outer
    circuit that verifies them all traced.  Each step is a phase span
    (`utils.timed_span`, recorded while profiling is on).  -> (the inner
    circuit, its proofs, the outer builder, its proof targets)."""
    from .. import zkaa
    from ..zkdsa import make_simple_signature_circuit

    config = CircuitConfig.test_config()
    with timed_span(f"aggregation of {num_proofs}: before the outer build"):
        with timed_span("inner circuit build"):
            inner = make_simple_signature_circuit(config, device)
        proofs = []
        for i, (key, msg) in enumerate(aggregation_draws(rng, num_proofs)):
            with timed_span(f"inner prove {i}"):
                sp = inner.prove(key, msg)
            with timed_span(f"inner verify {i}"):
                inner.verify(sp)
            proofs.append(sp.proof)
        with timed_span("outer circuit trace"):
            b, pts = zkaa.aggregation_builder(inner.data.verifier, num_proofs, config)
    return inner, proofs, b, pts


def build_aggregation(num_proofs: int = 4, device=DEFAULT_DEVICE):
    """Config 5: recursive aggregation of `num_proofs` zkDSA proofs (the
    inner circuit and the outer one both under test_config; the outer
    circuit of four proofs has 2^13 rows).

    Returns (make, meta) where make() -> (AggregationCircuit, inner_proofs);
    every inner proof is verified before it is aggregated.  As in the JAX
    package, the generator is seeded once, so a second make() draws new
    keys."""
    from .. import zkaa

    rng = random.Random(AGGREGATION_SEED)

    def make():
        inner, proofs, b, pts = aggregation_steps(rng, num_proofs, device)
        agg = zkaa.AggregationCircuit(data=b.build(device=device), proof_targets=pts,
                                      inner_verifier=inner.data.verifier)
        return agg, proofs

    return make, {"name": f"aggregation_{num_proofs}", "num_proofs": num_proofs}
