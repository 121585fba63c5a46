"""Write tests/torch_port_vectors.json: the JAX package's proof digests
that the PyTorch port (`plonky2_tpu_torch`) must reproduce byte for byte.

Nine circuits, built, proved and verified with the JAX package on the
CPU:

* `tiny`: the golden tiny circuit of tests/test_golden_vectors.py (its
  proof digest is also in tests/golden_vectors.json);
* `config1`: `bench.circuits.build_poseidon_chain(12)` under
  `standard_recursion_config` (degree 2^12, 135 wires, FRI arity 16,
  28 queries, 16-bit PoW);
* `small_chain`: the same chain under `test_config`, sized to 2^6 rows
  (the CPU test in tests/test_torch_prover.py);
* `config3`: `bench.circuits.build_smt_process(14)` under
  `standard_recursion_config` (51 chained depth-32 SMT process proofs,
  16,315 gates, degree 2^14);
* `small_smt`: the same SMT circuit under `test_config` at depth 4, sized
  to 2^7 rows (2 chained proofs; the CPU test in tests/test_torch_smt.py);
* `config2`: `bench.circuits.build_u32_mix(13)` under
  `standard_recursion_config` (u32 mul/add/xor/sub/compare, degree 2^13);
* `small_u32`: the same u32 loop and seed under `test_config`, sized to
  2^7 rows (the CPU tests in tests/test_torch_u32.py);
* `config4`: `bench.circuits.build_ecdsa(1)` under `standard_ecc_config`
  (one secp256k1 ECDSA verify, 136 wires, degree 2^16);
* `small_ecc`: secp256k1 curve_add, curve_double, a RandomAccessGate
  select over four points and the GLV scalar split under `test_config`,
  at 2^9 rows (the CPU tests in tests/test_torch_ecdsa.py).

For each: degree_bits, num_gates, the constants/sigmas cap, the public
inputs, the proof length, the proof sha256 and the sha256 of the
serialized verifier key.  `config4` and `small_ecc` also carry
`graph_sha256` (`graph_digest`): a digest of the builder's graph that a
test can recompute from the port's builder without a build.  The whole
run takes about 50 minutes on the CPU: the JAX package proves configs 1,
2, 3 and 4 (config 4 alone took 710 s, small_ecc 531 s).

    python scripts/make_torch_port_vectors.py           # print
    python scripts/make_torch_port_vectors.py --write   # rewrite the fixture

`--only a,b` computes just the named entries and keeps the others from the
fixture.  `--build-only a,b` builds the named entries without proving:
their build fields must equal the fixture's, and their proof fields are
kept from it (this adds a field that needs only the build, such as the
verifier-key digest, without the long proves).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_port_vectors.json")


def tiny(ir):
    """The circuit of tests/test_golden_vectors.py under test_config."""
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    z = b.mul_add(x, y, x)
    for t in b.two_to_one([x, y, z, x], [y, z, x, y]):
        b.register_public_input(t)
    return b, {x: 111, y: 222}


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


def small_u32(ir, degree_bits: int = 7):
    """`bench.circuits.build_u32_mix`'s loop (same seed, same unit, 16 rows
    of margin) under test_config."""
    import random
    import plonky2_tpu.gadgets  # noqa: F401  (attaches the u32 builder API)

    rng = random.Random(0x32BE7C4)
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    x = b.add_virtual_u32_target()
    y = b.add_virtual_u32_target()
    acc = x
    while b.num_gates() < (1 << degree_bits) - 16:
        lo, hi = b.mul_u32(acc, y)
        s, _carry = b.add_u32(lo, hi)
        xor = b.xor_u32(s, acc)
        d, _borrow = b.sub_u32(xor, y, b.zero_u32())
        _lt = b.is_less_than_u32(d, y)
        acc = d
    b.register_public_input(acc.target)
    return b, {x.target: rng.randrange(1 << 32), y.target: rng.randrange(1 << 32)}


def small_ecc(ir):
    """secp256k1 point ops, a RandomAccessGate select and the GLV scalar
    split under test_config (2^9 rows).  The public inputs are the limbs
    of p1 + p2, 2 p1, the selected point, then k1, k2 and their signs."""
    import random
    import plonky2_tpu.gadgets  # noqa: F401
    import plonky2_tpu.gadgets.curve  # noqa: F401
    from plonky2_tpu.field import secp
    from plonky2_tpu.gadgets.biguint import set_biguint_target

    rng = random.Random(0xECC5A11)
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
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
    return b, inputs


def graph_digest(builder) -> str:
    """sha256 of the builder's graph before `build()`: every row's gate key
    and constants, the public inputs, and the copy classes (each class its
    members' reprs, sorted).  Two builders with the same digest compile to
    the same arrays."""
    # The builder's `_parent` is a union-find forest; its roots are found
    # here with memoised paths (the builder's `_find` compresses one link a
    # call, which is quadratic on the long chains of a 2^16-row circuit).
    parent, root = builder._parent, {}

    def find(x):
        path = []
        while x not in root and x in parent:
            path.append(x)
            x = parent[x]
        r = root.get(x, x)
        for y in path:
            root[y] = r
        return r

    classes: dict = {}
    for t in set(parent) | set(parent.values()):
        classes.setdefault(find(t), []).append(repr(t))
    graph = {
        "rows": [[g.key(), [int(c) for c in cs]]
                 for g, cs in builder.gate_instances],
        "public_inputs": [repr(t) for t in builder.public_inputs],
        "copy_classes": sorted(sorted(c) for c in classes.values()),
    }
    raw = json.dumps(graph, separators=(",", ":"), default=repr)
    return hashlib.sha256(raw.encode()).hexdigest()


BUILD_FIELDS = ("degree_bits", "num_gates", "cs_cap", "verifier_data_sha256")
GRAPH_DIGESTED = ("config4", "small_ecc")


def _record(builder, inputs, prove: bool = True, graph: bool = False) -> dict:
    from plonky2_tpu.serialization import serialize_proof, serialize_verifier_data
    num_gates = builder.num_gates()
    digest = graph_digest(builder) if graph else None
    data = builder.build()
    out = {
        "degree_bits": data.common.degree_bits,
        "num_gates": num_gates,
        "cs_cap": [[int(x) for x in d] for d in data.verifier.cs_cap],
        "verifier_data_sha256": hashlib.sha256(
            serialize_verifier_data(data.verifier)).hexdigest(),
    }
    if digest is not None:
        out["graph_sha256"] = digest
    if prove:
        proof = data.prove(inputs)
        data.verify(proof)
        raw = serialize_proof(proof)
        out.update({
            "public_inputs": [int(x) for x in proof.public_inputs],
            "proof_len": len(raw),
            "proof_sha256": hashlib.sha256(raw).hexdigest(),
        })
    return out


def _circuits(ir):
    from plonky2_tpu.bench.circuits import (build_ecdsa, build_poseidon_chain,
                                            build_smt_process, build_u32_mix)
    return {
        "tiny": lambda: tiny(ir),
        "config1": lambda: build_poseidon_chain(12)[:2],
        "small_chain": lambda: small_chain(ir),
        "config3": lambda: build_smt_process(14)[:2],
        "small_smt": lambda: small_smt(ir),
        "config2": lambda: build_u32_mix(13)[:2],
        "small_u32": lambda: small_u32(ir),
        "small_ecc": lambda: small_ecc(ir),
        "config4": lambda: build_ecdsa(1)[:2],
    }


def load_fixture() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def compute_vectors(only=None, build_only=()) -> dict:
    """Every entry (or those named in `only`, the rest kept from the
    fixture); entries in `build_only` are built, not proved."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu import ir

    circuits = _circuits(ir)
    chosen = set(only or ()) | set(build_only)
    out = load_fixture() if chosen else {}
    for name, make in circuits.items():
        if chosen and name not in chosen:
            continue
        b, inputs = make()
        if name in build_only:
            rec = _record(b, inputs, prove=False, graph=name in GRAPH_DIGESTED)
            old = out[name]
            for k in BUILD_FIELDS[:3]:
                if rec[k] != old[k]:
                    raise SystemExit(f"{name}: {k} differs from the fixture")
            out[name] = {**old, **rec}
        else:
            out[name] = _record(b, inputs, graph=name in GRAPH_DIGESTED)
        print(f"{name}: done", file=sys.stderr, flush=True)
    return out


def _names(flag: str) -> list:
    if flag not in sys.argv:
        return []
    return sys.argv[sys.argv.index(flag) + 1].split(",")


if __name__ == "__main__":
    vectors = compute_vectors(_names("--only"), _names("--build-only"))
    if "--write" in sys.argv:
        with open(FIXTURE, "w") as f:
            json.dump(vectors, f, indent=1)
            f.write("\n")
        print(f"wrote {FIXTURE}")
    else:
        print(json.dumps(vectors, indent=1))
