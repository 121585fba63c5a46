"""The benchmark's circuits, built by the reference copy: the port's
`build_smt_process` (BASELINE config 3) and `build_ecdsa` (config 4),
copied whole.  Config 3 sizes itself: it repeats its unit until
`num_gates()` reaches the target, and the compiler pads to the next power
of two.  Config 4 has its natural size (one signature: 55,421 gates, 2^16
rows).  Each returns (builder, inputs, meta); the inputs' keys, in their
order, are the targets the benchmark's input makers fill.
"""

from __future__ import annotations

import random

from .field import gl
from .ir import CircuitBuilder, CircuitConfig


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


def build_smt_process(degree_bits: int = 14, n_levels: int = 32,
                      config: CircuitConfig | None = None):
    """Config 3: chained SMT process proofs at depth `n_levels` (the
    reference's src/smt process circuits), sized to degree 2^degree_bits,
    under `standard_recursion_config` unless `config` says otherwise.  The
    witnesses come from the native tree: an insert / update / insert mix
    drawn from a fixed seed.  Returns (builder, inputs, meta)."""
    from .gadgets.smt import SparseMerkleProcessProofTarget, verify_smt_transition
    from .smt import SparseMerkleTree

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
    from . import gadgets  # noqa: F401  (attaches the ECDSA builder API)
    from .field import secp
    from .gadgets.biguint import set_biguint_target
    from .gadgets.ecdsa import ECDSAPublicKeyTarget

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
