"""Write tests/torch_port_vectors.json: the JAX package's proof digests
that the PyTorch port (`plonky2_tpu_torch`) must reproduce byte for byte.

Four circuits, built, proved and verified with the JAX package on the
CPU:

* `config1`: `bench.circuits.build_poseidon_chain(12)` under
  `standard_recursion_config` (degree 2^12, 135 wires, FRI arity 16,
  28 queries, 16-bit PoW);
* `small_chain`: the same chain under `test_config`, sized to 2^6 rows
  (the CPU test in tests/test_torch_prover.py);
* `config3`: `bench.circuits.build_smt_process(14)` under
  `standard_recursion_config` (51 chained depth-32 SMT process proofs,
  16,315 gates, degree 2^14);
* `small_smt`: the same SMT circuit under `test_config` at depth 4, sized
  to 2^7 rows (2 chained proofs; the CPU test in tests/test_torch_smt.py).

For each: degree_bits, num_gates, the constants/sigmas cap, the public
inputs, the proof length and the proof sha256.  The whole run takes about
20 minutes on one CPU core: the JAX package proves config 1 and config 3.

    python scripts/make_torch_port_vectors.py           # print
    python scripts/make_torch_port_vectors.py --write   # rewrite the fixture
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_port_vectors.json")


def small_chain(ir, degree_bits: int = 6):
    """Poseidon two_to_one chain under test_config, sized like
    `build_poseidon_chain` (8 rows of margin below 2^degree_bits)."""
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    xs = [b.add_virtual_target() for _ in range(4)]
    cur = xs
    while b.num_gates() < (1 << degree_bits) - 8:
        cur = b.two_to_one(cur, cur)
    for t in cur:
        b.register_public_input(t)
    return b, {xs[i]: i + 1 for i in range(4)}


def small_smt(ir, degree_bits: int = 7, n_levels: int = 4):
    """`bench.circuits.build_smt_process` (same seed, same
    insert/update/insert mix) under test_config at a small depth."""
    import random
    from plonky2_tpu.bench.circuits import _fill, _target_rows
    from plonky2_tpu.gadgets.smt import (SparseMerkleProcessProofTarget,
                                         verify_smt_transition)
    from plonky2_tpu.smt import SparseMerkleTree

    rng = random.Random(0x517BE7C4)
    P = (1 << 64) - (1 << 32) + 1

    def rand_hash():
        return tuple(rng.randrange(P) for _ in range(4))

    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
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
    return b, inputs


def _record(builder, inputs, serialize_proof) -> dict:
    num_gates = builder.num_gates()
    data = builder.build()
    proof = data.prove(inputs)
    data.verify(proof)
    raw = serialize_proof(proof)
    return {
        "degree_bits": data.common.degree_bits,
        "num_gates": num_gates,
        "cs_cap": [[int(x) for x in d] for d in data.verifier.cs_cap],
        "public_inputs": [int(x) for x in proof.public_inputs],
        "proof_len": len(raw),
        "proof_sha256": hashlib.sha256(raw).hexdigest(),
    }


def compute_vectors() -> dict:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu import ir
    from plonky2_tpu.bench.circuits import build_poseidon_chain, build_smt_process
    from plonky2_tpu.serialization import serialize_proof

    out = {}
    b, inputs, _ = build_poseidon_chain(12)
    out["config1"] = _record(b, inputs, serialize_proof)
    b, inputs = small_chain(ir)
    out["small_chain"] = _record(b, inputs, serialize_proof)
    b, inputs, _ = build_smt_process(14)
    out["config3"] = _record(b, inputs, serialize_proof)
    b, inputs = small_smt(ir)
    out["small_smt"] = _record(b, inputs, serialize_proof)
    return out


if __name__ == "__main__":
    vectors = compute_vectors()
    if "--write" in sys.argv:
        with open(FIXTURE, "w") as f:
            json.dump(vectors, f, indent=1)
            f.write("\n")
        print(f"wrote {FIXTURE}")
    else:
        print(json.dumps(vectors, indent=1))
