"""Write tests/torch_port_vectors.json: the JAX package's proof digests
that the PyTorch port (`plonky2_tpu_torch`) must reproduce byte for byte.

Twenty-three entries.  Twenty are circuits, built, proved and verified
with the JAX package on the CPU:

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
* `config4_b2`: `build_ecdsa(2)`, two verifies, degree 2^17 (the perf
  driver's default batch; proved on the card by `chip_smoke.py`);
* `small_ecc`: secp256k1 curve_add, curve_double, a RandomAccessGate
  select over four points and the GLV scalar split under `test_config`,
  at 2^9 rows (the CPU tests in tests/test_torch_ecdsa.py);
* `small_ext`: every GF(p^2), exponentiation and coset-interpolation
  builder method and the `ext_inv` hint under `test_config`, 2^4 rows
  (tests/test_torch_extension_gates.py);
* `small_recursion` and `config5`, each `{"inner": ..., "outer": ...}`:
  the inner circuit of tests/test_recursion_e2e.py and the 2^12-row
  circuit verifying its proof; `bench.circuits.build_aggregation(4)`, the
  zkDSA circuit with its four proofs (their digests in draw order) and
  the 2^13-row circuit verifying all four, both under `test_config`;
* `small_keccak`, `{"round": ..., "chain": ...}`: the u64 xor/rotate/chi
  circuit of tests/test_keccak.py under `test_config` (inputs from seed
  0xEC), and the 20-step `two_to_one` chain of tests/test_keccak_config.py
  under `keccak_config` (Keccak Merkle trees, transcript and grind);
* `small_poseidon2`: one `two_to_one` under `test_config` with the
  Poseidon2 in-circuit hasher (tests/test_poseidon2.py), inputs from seed
  0xB052;
* `config1_p2`: config 1's chain under `poseidon2_config` (every
  `two_to_one` a Poseidon2Gate row; Poseidon Merkle trees);
* `keccak4`: the reference's 4-block Keccak-256 circuit
  (keccak256.rs:256-338) under `keccak_config`, 2^15 rows, proved for the
  four Ethereum trie nodes of `plonky2_tpu_torch.bench.circuits.
  ETH_LONG_VECTORS`; its `public_inputs`, `proof_len`, `proof_sha256` and
  `wire_matrix_sha256` are lists, one item per node;
* `small_lookup`: the lookup circuit of tests/test_lookup.py
  (`build_lookup_circuit`, a 16-entry table) for the inputs
  [3, 7, 7, 0, 15, 4, 4, 4] under `test_config`;
* `mixed_small`: the JAX package's `bench.circuits.build_mixed_small()`
  (u32, xor, a lookup and nonnative ops under `test_config`);
* `lookup8`: the port's `bench.circuits.build_lookup_bytes(13)` built by
  the JAX builder: 47,616 lookups into a 256-entry 8-bit S-box under
  `standard_recursion_config`, 2^13 rows.

`config4_b20` is `build_ecdsa(20)`, the reference perf binary's default
batch (2^20 rows), traced and not built (the JAX package cannot build or
prove it on a CPU in reasonable time): its batch, gate count and graph
digest, which `chip_smoke.py` holds the port's builder to before it
proves the circuit on the card.

The other two are the JAX package's `parallel.sharded_prove_step` (one
sharded commit and constraint pass) on its 8-device CPU mesh, for wires
drawn by `mesh_step_wires` from `np.random.RandomState(0)`, rate 3:

* `mesh_step_small`: wires [8, 32], cap height 2 (tests/test_torch_mesh.py);
* `mesh_step`: wires [136, 2^12], cap height 4 (`chip_smoke.py`).

Each holds its shape, rate, cap height and mesh size, the cap as integers
and the sha256 of the sample (the [N] uint64 vector, little-endian).  The
script sets XLA_FLAGS to 8 host devices before JAX starts its CPU client,
as tests/conftest.py does.

For each circuit: degree_bits, num_gates, the constants/sigmas cap, the public
inputs, the proof length, the proof sha256, the sha256 of the
serialized verifier key, `prover_data_sha256` (the sha256 of
`serialize_prover_data(data.prover)`, the circuit cache's bytes) and
`wire_matrix_sha256` (the sha256 of the witness's [num_wires, n] uint64
wire matrix, little-endian, row by row, as the JAX prover's phase 1
computes it: `generate_witness_tape`, `scatter`, then every gate's
batched `aux_fill`).  `config4`, `config4_b2`, `small_ecc`, the two outer circuits and the three
lookup circuits also carry `graph_sha256`
(`plonky2_tpu_torch.ir.digest.graph_digest`; `keccak4` too): a
digest of the builder's graph that a test can recompute from the port's
builder without a build.  The whole
run takes about 50 minutes on the CPU: the JAX package proves configs 1,
2, 3 and 4 (config 4 alone took 710 s, small_ecc 531 s).

    python scripts/make_torch_port_vectors.py           # print
    python scripts/make_torch_port_vectors.py --write   # rewrite the fixture

`--only a,b` computes just the named entries and keeps the others from the
fixture.  `--build-only a,b` builds the named entries and runs their
witness without proving: every field it recomputes that the fixture
already has must equal the fixture's, and their proof fields are kept
from it (this adds a field that needs only the build and the witness,
such as the verifier-key, prover-data and wire-matrix digests, without
the long proves); it does not apply to the entries of `OWN_RECORD`.
Config 5's entries took about 20 minutes, each name in its own process;
`small_keccak`, `small_poseidon2`, `config1_p2` and `keccak4` 8.5, 2.3,
7.0 and 8.5 minutes, each in its own process; `small_lookup`,
`mixed_small` and `lookup8`, each in its own process at once, the times
in ROADMAP.md (queue 1).
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


def small_chain(ir, degree_bits: int = 6, config=None):
    """Poseidon two_to_one chain under test_config (or `config`), sized
    like `build_poseidon_chain` (8 rows of margin below 2^degree_bits)."""
    b = ir.CircuitBuilder(config or ir.CircuitConfig.test_config())
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


def small_ext(ir):
    """Every GF(p^2), exponentiation and coset-interpolation builder method
    and the `ext_inv` hint under test_config.  The public inputs are each
    result's limbs, in the order the methods are called.  `ir` is the JAX
    package's or the port's; the hint comes from the same package."""
    import importlib
    import random
    package = ir.__name__.rsplit(".", 1)[0]
    _inv_extension = importlib.import_module(
        package + ".recursion.verifier")._inv_extension

    rng = random.Random(0xE87)
    P = (1 << 64) - (1 << 32) + 1
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    a, c, d, alpha, z = (b.add_virtual_extension_target() for _ in range(5))
    base, e, shift = (b.add_virtual_target() for _ in range(3))
    terms = [b.add_virtual_target() for _ in range(23)]
    values = [b.add_virtual_extension_target() for _ in range(4)]
    outs = [
        b.add_extension(a, c),
        b.sub_extension(a, c),
        b.mul_extension(a, c),
        b.mul_add_extension(a, c, d),
        b.scalar_mul_ext(5, a),
        b.arithmetic_extension(3, 4, a, c, d),
        b.reduce_with_powers_ext(alpha, terms),
        b.reduce_with_powers_ext_circuit(alpha, [a, c, d, z] * 3),
        b.interpolate_coset(2, shift, values, z),
        _inv_extension(b, d),
    ]
    bits = b.split_le(e, 16)
    outs.append((b.exp_from_bits(base, bits), b.exp_u64(base, e, 16)))
    for o in outs:
        b.register_public_inputs(list(o))
    inputs: dict = {e: rng.randrange(1 << 16), base: rng.randrange(P),
                    shift: rng.randrange(1, P)}
    for t in (*a, *c, *d, *alpha, *z, *terms, *(x for v in values for x in v)):
        inputs[t] = rng.randrange(P)
    return b, inputs


def recursion_inner(ir):
    """The inner circuit of tests/test_recursion_e2e.py."""
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    h = b.hash_n_to_hash_no_pad([x, y])
    b.register_public_inputs([x, y] + h)
    return b, {x: 3, y: 5}


def _module(ir, name: str):
    """The module `name` of the package that `ir` belongs to."""
    import importlib
    return importlib.import_module(ir.__name__.rsplit(".", 1)[0] + "." + name)


def keccak_round(ir):
    """The u64 xor-many / rotate / chi circuit of tests/test_keccak.py
    `test_one_theta_chi_round_circuit` under test_config."""
    import random
    _module(ir, "gadgets.keccak")          # attaches the u32 and u64 API
    rng = random.Random(0xEC)
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    lanes = [[b.add_virtual_u32_target(), b.add_virtual_u32_target()]
             for _ in range(5)]
    xm = b.unsafe_xor_many_u64(lanes)
    rot = b.lrot_u64(xm, 1)
    chi = b.xor_u64(lanes[0], b.and_u64(lanes[2], b.not_u64(lanes[1])))
    for pair in [xm, rot, chi]:
        b.register_public_input(pair[0].target)
        b.register_public_input(pair[1].target)
    inputs = {}
    for lane in lanes:
        v = rng.randrange(1 << 64)
        inputs[lane[0].target] = v & 0xFFFFFFFF
        inputs[lane[1].target] = v >> 32
    return b, inputs


def keccak_chain(ir):
    """The 20-step two_to_one chain of tests/test_keccak_config.py under
    keccak_config."""
    b = ir.CircuitBuilder(ir.CircuitConfig.keccak_config())
    xs = [b.add_virtual_target() for _ in range(4)]
    cur = xs
    for _ in range(20):
        cur = b.two_to_one(cur, cur)
    for t in cur:
        b.register_public_input(t)
    return b, {xs[i]: i + 1 for i in range(4)}


def small_poseidon2(ir):
    """tests/test_poseidon2.py `test_poseidon2_circuit_oracle`: one
    two_to_one under test_config with the Poseidon2 in-circuit hasher."""
    import dataclasses
    import random
    rng = random.Random(0xB052)
    P = (1 << 64) - (1 << 32) + 1
    cfg = dataclasses.replace(ir.CircuitConfig.test_config(),
                              algebraic_hasher="poseidon2")
    b = ir.CircuitBuilder(cfg)
    x = b.add_virtual_targets(4)
    y = b.add_virtual_targets(4)
    b.register_public_inputs(b.two_to_one(x, y))
    return b, {t: rng.randrange(P) for t in x + y}


def keccak_circuit(ir, blocks: int, config):
    """The reference's Keccak-256 circuit (keccak256.rs:256-338): a
    `blocks`-block hash input, `hash_keccak256`, the 8 output limbs
    public.  -> (builder, hash input target, the gadget module)."""
    kk = _module(ir, "gadgets.keccak")
    b = ir.CircuitBuilder(config)
    ht = b.add_virtual_hash_input_target(blocks, kk.RATE_BITS)
    out = b.hash_keccak256(ht)
    for limb in out.limbs[:8]:
        b.register_public_input(limb.target)
    return b, ht, kk


def small_keccak(ir) -> dict:
    return {"round": _record(*keccak_round(ir)),
            "chain": _record(*keccak_chain(ir))}


def keccak4(ir) -> dict:
    """The 4-block Keccak-256 circuit under keccak_config, proved for each
    Ethereum trie node of ETH_LONG_VECTORS; each proof's public inputs, as
    little-endian u32s, are the node's digest."""
    from plonky2_tpu.serialization import serialize_proof
    from plonky2_tpu_torch.bench.circuits import ETH_LONG_VECTORS
    from plonky2_tpu_torch.ir.digest import graph_digest
    b, ht, kk = keccak_circuit(ir, 4, ir.CircuitConfig.keccak_config())
    num_gates, digest = b.num_gates(), graph_digest(b)
    data = b.build()
    witnesses = []
    for hx, _ in ETH_LONG_VECTORS:
        inputs: dict = {}
        kk.set_keccak256_input_target(inputs, ht, bytes.fromhex(hx))
        witnesses.append(inputs)
    out, _ = _record_data(data, num_gates, witnesses[0], prove=False,
                          digest=digest)
    lists: dict = {k: [] for k in ("wire_matrix_sha256", "public_inputs",
                                   "proof_len", "proof_sha256")}
    for inputs, (hx, want) in zip(witnesses, ETH_LONG_VECTORS):
        lists["wire_matrix_sha256"].append(
            wire_matrix_sha256(wire_matrix(data.prover, inputs)))
        proof = data.prove(inputs)
        data.verify(proof)
        pi_hex = b"".join(int(v).to_bytes(4, "little")
                          for v in proof.public_inputs).hex()
        assert pi_hex == want, hx
        raw = serialize_proof(proof)
        lists["public_inputs"].append([int(x) for x in proof.public_inputs])
        lists["proof_len"].append(len(raw))
        lists["proof_sha256"].append(hashlib.sha256(raw).hexdigest())
        print(f"keccak4: node {len(lists['proof_len'])} proved",
              file=sys.stderr, flush=True)
    out.update(lists)
    return out


LOOKUP_TABLE = [(i, (i ** 3 + 5) % 97) for i in range(16)]


def small_lookup(ir, xs=(3, 7, 7, 0, 15, 4, 4, 4)):
    """`build_lookup_circuit(xs)` of tests/test_lookup.py: every input and
    then every looked-up output public, under test_config."""
    b = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    tid = b.add_lookup_table(LOOKUP_TABLE)
    ins = [b.add_virtual_target() for _ in xs]
    for t in ins:
        b.register_public_input(t)
    for t in ins:
        b.register_public_input(b.lookup(t, tid))
    return b, dict(zip(ins, xs))


def lookup8(ir, degree_bits: int = 13):
    """The JAX twin of the port's `bench.circuits.build_lookup_bytes`, by
    the same builder calls: a 256-entry table (i, S[i]) with S a
    permutation of 0..255, 6 * (2^degree_bits - 256) lookups of virtual
    targets holding bytes, the first four outputs public, under
    standard_recursion_config; S and the bytes from seed 0x100C8."""
    import random
    rng = random.Random(0x100C8)
    sbox = list(range(256))
    rng.shuffle(sbox)
    b = ir.CircuitBuilder(ir.CircuitConfig.standard_recursion_config())
    tid = b.add_lookup_table(list(enumerate(sbox)))
    xs = [b.add_virtual_target() for _ in range(6 * ((1 << degree_bits) - 256))]
    ys = [b.lookup(x, tid) for x in xs]
    b.register_public_inputs(ys[:4])
    return b, {x: rng.randrange(256) for x in xs}


GRAPH_DIGESTED = ("config4", "config4_b2", "small_ecc", "small_recursion", "config5",
                  "small_lookup", "mixed_small", "lookup8")


def wire_matrix(pd, inputs):
    """The JAX prover's phase 1 (`plonky2_tpu/prove/prover.py:529-556`) on
    the native tape: [num_wires, n] uint64."""
    import numpy as np
    from plonky2_tpu.witness.tape import generate_witness_tape
    common = pd.common
    store = generate_witness_tape(pd, inputs)
    if store is None:
        raise SystemExit("the JAX package's native witness library did not build")
    wires = store.scatter(common.config.num_wires, 1 << common.degree_bits)
    for gi, gate in enumerate(common.gates):
        rows = pd.gate_rows.get(gi)
        if hasattr(gate, "aux_fill") and rows:
            gate.aux_fill(np.asarray(rows, dtype=np.int64), wires)
    return wires


def wire_matrix_sha256(wires) -> str:
    """sha256 of a [num_wires, n] wire matrix: its uint64 values,
    little-endian, row by row."""
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(wires, dtype="<u8").tobytes()).hexdigest()


def _record(builder, inputs, prove: bool = True, graph: bool = False) -> dict:
    from plonky2_tpu_torch.ir.digest import graph_digest
    num_gates = builder.num_gates()
    digest = graph_digest(builder) if graph else None
    return _record_data(builder.build(), num_gates, inputs, prove, digest)[0]


def _record_data(data, num_gates, inputs, prove=True, digest=None):
    """-> (the entry of a built circuit, its proof or None)."""
    from plonky2_tpu.serialization import (serialize_proof, serialize_prover_data,
                                           serialize_verifier_data)
    out = {
        "degree_bits": data.common.degree_bits,
        "num_gates": num_gates,
        "cs_cap": [[int(x) for x in d] for d in data.verifier.cs_cap],
        "verifier_data_sha256": hashlib.sha256(
            serialize_verifier_data(data.verifier)).hexdigest(),
        "prover_data_sha256": hashlib.sha256(
            serialize_prover_data(data.prover)).hexdigest(),
        "wire_matrix_sha256": wire_matrix_sha256(wire_matrix(data.prover, inputs)),
    }
    if digest is not None:
        out["graph_sha256"] = digest
    proof = None
    if prove:
        proof = data.prove(inputs)
        data.verify(proof)
        raw = serialize_proof(proof)
        out.update({
            "public_inputs": [int(x) for x in proof.public_inputs],
            "proof_len": len(raw),
            "proof_sha256": hashlib.sha256(raw).hexdigest(),
        })
    return out, proof


class _Digesting:
    """Wraps `CircuitBuilder.build` so that the graph digest of every
    builder built inside the block is taken just before its build."""

    def __init__(self, ir):
        self.cls, self.digests, self.gates = ir.CircuitBuilder, [], []

    def __enter__(self):
        from plonky2_tpu_torch.ir.digest import graph_digest
        build, outer = self.cls.build, self

        def digesting_build(b, *args, **kwargs):
            outer.digests.append(graph_digest(b))
            outer.gates.append(b.num_gates())
            return build(b, *args, **kwargs)

        self._build = build
        self.cls.build = digesting_build
        return self

    def __exit__(self, *exc):
        self.cls.build = self._build


def small_recursion(ir) -> dict:
    """`inner`: the circuit of tests/test_recursion_e2e.py, proved;
    `outer`: a test_config circuit verifying that proof in-circuit
    (`add_proof_verification`, public inputs re-registered), proved."""
    from plonky2_tpu.recursion import add_proof_verification, set_proof_witness
    b, inputs = recursion_inner(ir)
    num_gates = b.num_gates()
    inner_data = b.build()
    inner, inner_proof = _record_data(inner_data, num_gates, inputs)
    bo = ir.CircuitBuilder(ir.CircuitConfig.test_config())
    pt = add_proof_verification(bo, inner_data.verifier)
    bo.register_public_inputs(pt.public_inputs)
    outer_inputs: dict = {}
    set_proof_witness(outer_inputs, pt, inner_proof)
    return {"inner": inner, "outer": _record(bo, outer_inputs, graph=True)}


def config5(ir) -> dict:
    """`bench.circuits.build_aggregation(4)`: `inner` is the zkDSA circuit
    under test_config with its four proofs (one key and one message drawn
    for each, in turn), `outer` the 2^13-row test_config circuit that
    verifies all four, proved."""
    from plonky2_tpu.bench.circuits import build_aggregation
    from plonky2_tpu.recursion import set_proof_witness
    from plonky2_tpu.serialization import serialize_proof, serialize_verifier_data
    make, _meta = build_aggregation(4)
    with _Digesting(ir) as dig:
        agg, proofs = make()
    inner_vd = agg.inner_verifier
    raws = [serialize_proof(p) for p in proofs]
    inner = {
        "degree_bits": inner_vd.common.degree_bits,
        "num_gates": dig.gates[0],
        "verifier_data_sha256": hashlib.sha256(
            serialize_verifier_data(inner_vd)).hexdigest(),
        "public_inputs": [[int(x) for x in p.public_inputs] for p in proofs],
        "proof_len": [len(r) for r in raws],
        "proof_sha256": [hashlib.sha256(r).hexdigest() for r in raws],
    }
    outer_inputs: dict = {}
    for pt, p in zip(agg.proof_targets, proofs):
        set_proof_witness(outer_inputs, pt, p)
    outer, _ = _record_data(agg.data, dig.gates[1], outer_inputs,
                            digest=dig.digests[1])
    assert outer["public_inputs"] == [int(v) for p in proofs for v in p.public_inputs]
    return {"inner": inner, "outer": outer}


def _circuits(ir):
    from plonky2_tpu.bench.circuits import (build_ecdsa, build_mixed_small,
                                            build_poseidon_chain,
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
        "config4_b2": lambda: build_ecdsa(2)[:2],
        "small_ext": lambda: small_ext(ir),
        "small_poseidon2": lambda: small_poseidon2(ir),
        "config1_p2": lambda: small_chain(ir, 12,
                                          ir.CircuitConfig.poseidon2_config()),
        "small_lookup": lambda: small_lookup(ir),
        "mixed_small": lambda: build_mixed_small()[:2],
        "lookup8": lambda: lookup8(ir),
    }


MESH_DEVICES = 8


def mesh_step_wires(shape):
    """The wires [P, n] of a `mesh_step` entry: uint64 values below 2^62
    from np.random.RandomState(0), as `__graft_entry__.entry()` draws them."""
    import numpy as np
    rng = np.random.RandomState(0)
    return rng.randint(0, 1 << 62, size=shape).astype(np.uint64)


def mesh_step(shape, cap_height: int, rate_bits: int = 3) -> dict:
    """The JAX `sharded_prove_step` on the 8-device CPU mesh: its cap and
    the sha256 of its sample."""
    import jax
    import numpy as np
    from plonky2_tpu.parallel import make_prover_mesh, sharded_prove_step
    if len(jax.devices()) < MESH_DEVICES:
        raise SystemExit(f"JAX has {len(jax.devices())} devices, not {MESH_DEVICES}: "
                         f"XLA_FLAGS was set after JAX started its CPU client")
    cap, sample = sharded_prove_step(make_prover_mesh(MESH_DEVICES),
                                     mesh_step_wires(shape), rate_bits, cap_height)
    sample = np.ascontiguousarray(np.asarray(sample), dtype="<u8")
    return {"shape": list(shape), "rate_bits": rate_bits, "cap_height": cap_height,
            "devices": MESH_DEVICES,
            "cap": [[int(x) for x in row] for row in np.asarray(cap)],
            "sample_sha256": hashlib.sha256(sample.tobytes()).hexdigest()}


def config4_b20(ir) -> dict:
    """`build_ecdsa(20)`, the reference perf binary's default batch: its
    gate count and graph digest, traced without a build (the JAX package
    cannot build or prove 2^20 rows on a CPU in reasonable time)."""
    from plonky2_tpu.bench.circuits import build_ecdsa
    from plonky2_tpu_torch.ir.digest import graph_digest
    b = build_ecdsa(20)[0]
    return {"batch": 20, "num_gates": b.num_gates(), "graph_sha256": graph_digest(b)}


# Entries recorded by a function of their own: {"inner": ..., "outer": ...}
# (an inner circuit proved, then an outer circuit verifying it), two small
# Keccak circuits, one circuit proved for several witnesses, one sharded
# step on the JAX mesh, or a graph digest alone.
OWN_RECORD = {"small_recursion": small_recursion, "config5": config5,
             "small_keccak": small_keccak, "keccak4": keccak4,
             "mesh_step_small": lambda ir: mesh_step((8, 32), 2),
             "mesh_step": lambda ir: mesh_step((136, 1 << 12), 4),
             "config4_b20": config4_b20}


def load_fixture() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def compute_vectors(only=None, build_only=()) -> dict:
    """Every entry (or those named in `only`, the rest kept from the
    fixture); entries in `build_only` are built, not proved."""
    sys.path.insert(0, ROOT)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={MESH_DEVICES}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu import ir

    circuits = _circuits(ir)
    chosen = set(only or ()) | set(build_only)
    out = load_fixture() if chosen else {}
    for name, make in {**circuits, **OWN_RECORD}.items():
        if chosen and name not in chosen:
            continue
        if name in OWN_RECORD:
            if name in build_only:
                raise SystemExit(f"{name}: --build-only does not apply")
            out[name] = OWN_RECORD[name](ir)
            print(f"{name}: done", file=sys.stderr, flush=True)
            continue
        b, inputs = make()
        if name in build_only:
            rec = _record(b, inputs, prove=False, graph=name in GRAPH_DIGESTED)
            old = out[name]
            for k in rec:
                if k in old and rec[k] != old[k]:
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
