"""The port's SMT path (`plonky2_tpu_torch.smt`, `gates.base_sum`,
`gadgets.smt`, `bench.build_smt_process`) against the JAX package.

Exact equality (tolerance 0): integer field arithmetic and host hashing.

* the native sparse Merkle tree: a seeded insert / update / remove / set
  sequence gives the JAX tree's roots, process proofs and inclusion proofs,
  and every process proof passes the port's native verifier;
* BaseSumGate: `eval_batch_fast` equals the JAX `eval_batch_fast` and the
  port's own generic `eval`, on wires with non-boolean limbs; its generator
  gives the JAX generator's limbs;
* the SMT process circuit at depth 4 under test_config (2 chained proofs,
  2^7 rows): the same gate instances, copy classes, public inputs, custom
  generators and witness inputs as the JAX builder's (no compile), and the
  port's CPU proof gives the `small_smt` digest of tests/torch_port_vectors.json.
"""
import hashlib
import importlib.util
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu import ir as jir
from plonky2_tpu import smt as jsmt
from plonky2_tpu.gates.base_sum import BaseSumGate as JBaseSumGate
from plonky2_tpu_torch import smt
from plonky2_tpu_torch.bench import build_smt_process
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.gates import BaseSumGate, BatchAlg, EvalVars
from plonky2_tpu_torch.ir import CircuitConfig
from plonky2_tpu_torch.serialization import serialize_proof

HERE = os.path.dirname(os.path.abspath(__file__))


def _proof_fields(p):
    return (p.old_root, p.old_key, p.old_value, p.new_root, p.new_key,
            p.new_value, list(p.siblings), p.is_old0, p.fnc.name)


def test_sparse_merkle_tree_equals_jax():
    rng = random.Random(0x5E7)

    def rand_hash():
        return tuple(rng.randrange(gl.P) for _ in range(4))

    tree, jtree = smt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    keys = [rand_hash() for _ in range(12)]
    # keys sharing low bits force deep paths and leaf collisions
    keys += [(k[0] & 0xF, *k[1:]) for k in keys[:4]]
    ops = [("insert", k, rand_hash()) for k in keys]
    ops += [("update", keys[i], rand_hash()) for i in (0, 5, 13)]
    ops += [("remove", keys[i], None) for i in (1, 12, 14)]
    ops += [("set", keys[1], rand_hash()), ("set", keys[2], smt.ZERO_HASH),
            ("set", rand_hash(), smt.ZERO_HASH)]
    for op, key, value in ops:
        args = (key,) if value is None else (key, value)
        got = getattr(tree, op)(*args)
        want = getattr(jsmt.SparseMerkleTree, op)(jtree, *args)
        assert _proof_fields(got) == _proof_fields(want), op
        assert tree.get_root() == jtree.get_root()
        smt.verify_smt_process_proof(smt.PoseidonNodeHash, got, num_levels=32)
    for key in keys + [rand_hash()]:
        got, want = tree.find(key), jtree.find(key)
        assert (got.root, got.found, got.value, got.not_found_key,
                got.not_found_value, got.siblings, got.is_old0) == \
            (want.root, want.found, want.value, want.not_found_key,
             want.not_found_value, want.siblings, want.is_old0)
        smt.verify_smt_inclusion_proof(smt.PoseidonNodeHash, got, num_levels=32)
    bad = tree.find(keys[0])
    bad.root = (bad.root[0] ^ 1, *bad.root[1:])
    with pytest.raises(ValueError, match="root mismatch"):
        smt.verify_smt_inclusion_proof(smt.PoseidonNodeHash, bad, num_levels=32)


def test_hash_out_serde_equals_jax():
    """The reference's serde forms of a HashOut (32 bytes little-endian and
    0x-prefixed big-endian hex) equal the JAX package's, both ways, on
    seeded values with the field's edges; both reject what is not one."""
    from plonky2_tpu.smt import hash_out as jhash_out
    rng = random.Random(0x5E8)
    values = [smt.ZERO_HASH, (gl.P - 1,) * 4, (1, 0, 0, gl.P - 1)]
    values += [tuple(rng.randrange(gl.P) for _ in range(4)) for _ in range(20)]
    for h in values:
        raw, hx = smt.to_bytes_le(h), smt.to_hex(h)
        assert raw == jhash_out.to_bytes_le(h)
        assert hx == jhash_out.to_hex(h)
        assert smt.from_bytes_le(raw) == jhash_out.from_bytes_le(raw) == h
        assert smt.from_hex(hx) == jhash_out.from_hex(hx) == h
        # hex without its leading zeros reads back the same
        short = "0x" + hx[2:].lstrip("0")
        assert smt.from_hex(short) == jhash_out.from_hex(short) == h
    not_canonical = gl.P.to_bytes(8, "little") + bytes(24)
    for bad in (bytes(31), not_canonical):
        with pytest.raises(ValueError):
            smt.from_bytes_le(bad)
        with pytest.raises(AssertionError):
            jhash_out.from_bytes_le(bad)
    with pytest.raises(ValueError):
        smt.from_hex("00" * 32)


def test_root_data_tmp_equals_jax():
    """A tree over the single-slot root store gives the JAX tree's roots
    and proofs, and the store keeps only the latest root."""
    from plonky2_tpu.smt.tree import RootDataTmp as JRootDataTmp
    rng = random.Random(0x5E9)

    def rand_hash():
        return tuple(rng.randrange(gl.P) for _ in range(4))

    store, jstore = smt.RootDataTmp(), JRootDataTmp()
    tree = smt.SparseMerkleTree(roots_db=store)
    jtree = jsmt.SparseMerkleTree(roots_db=jstore)
    assert store.get() == jstore.get() == smt.ZERO_HASH
    keys = [rand_hash() for _ in range(6)]
    for op, key, value in ([("insert", k, rand_hash()) for k in keys]
                           + [("update", keys[2], rand_hash()), ("remove", keys[4], None)]):
        args = (key,) if value is None else (key, value)
        got = getattr(tree, op)(*args)
        want = getattr(jsmt.SparseMerkleTree, op)(jtree, *args)
        assert _proof_fields(got) == _proof_fields(want), op
        assert store.get() == jstore.get() == got.new_root
        assert vars(store) == vars(jstore)
    start = rand_hash()
    assert smt.RootDataTmp(start).get() == JRootDataTmp(start).get() == start


def test_base_sum_gate_eval_forms_and_generator_agree():
    L, m = 64, 9
    rng = np.random.RandomState(0xBA5E)
    wires = rng.randint(0, 2, size=(1 + L, m)).astype(np.uint64)
    wires[0] = rng.randint(0, 2**62, size=m).astype(np.uint64)
    wires[5, 2] = 2                                   # non-boolean limbs
    wires[40, 7] = gl.P - 1
    wires[L, 0] = 2**63 + 5
    gate, jgate = BaseSumGate(2, L), JBaseSumGate(2, L)
    wt = gl.to_tensor(wires)
    fast = gate.eval_batch_fast(wt, None, None)
    generic = gate.eval(EvalVars(list(wt), [], []), BatchAlg((m,), "cpu"))
    assert torch.equal(fast, torch.stack(generic))
    want = np.stack([np.asarray(c) for c in
                     jgate.eval_batch_fast(jnp.asarray(wires), None, None)])
    assert np.array_equal(gl.from_tensor(fast), want)
    assert gate.key() == jgate.key() and gate.degree == jgate.degree
    for value in (0, 1, 2**63 + 12345, gl.P - 1):
        got = gate.generators(3, [])[0].run(lambda t: value)
        jgot = jgate.generators(3, [])[0].run(lambda t: value)
        assert [(tuple(w), v) for w, v in got] == [(tuple(w), v) for w, v in jgot]
        assert sum(v << i for i, (_, v) in enumerate(got)) == value
    # base 3: the generic range product has degree 3
    g3 = BaseSumGate(3, 4)
    w3 = gl.to_tensor(rng.randint(0, 4, size=(5, m)).astype(np.uint64))
    assert torch.equal(g3.eval_batch_fast(w3, None, None),
                       torch.stack(g3.eval(EvalVars(list(w3), [], []),
                                           BatchAlg((m,), "cpu"))))


def _load_vector_script():
    path = os.path.join(os.path.dirname(HERE), "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


@pytest.fixture(scope="module")
def small_smt():
    return build_smt_process(7, 4, CircuitConfig.test_config())


def test_smt_circuit_graph_equals_jax(small_smt):
    b, inputs, meta = small_smt
    jb, jinputs = _load_vector_script().small_smt(jir)
    assert meta["num_proofs"] == 2
    assert [(g.key(), c) for g, c in b.gate_instances] == \
        [(g.key(), c) for g, c in jb.gate_instances]
    assert b.public_inputs == jb.public_inputs
    assert [(g.name, g.deps, g.outs) for g in b.custom_generators] == \
        [(g.name, g.deps, g.outs) for g in jb.custom_generators]
    assert inputs == jinputs

    def classes(builder):
        out: dict = {}
        for t in set(builder._parent) | set(builder._parent.values()):
            out.setdefault(builder._find(t), []).append(repr(t))
        return sorted(sorted(c) for c in out.values())
    assert classes(b) == classes(jb)


def test_small_smt_proof_matches_fixture(small_smt):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        want = json.load(f)["small_smt"]
    b, inputs, _ = small_smt
    assert b.num_gates() == want["num_gates"]
    data = b.build(device="cpu")
    assert data.common.degree_bits == want["degree_bits"]
    assert [g.key() for g in data.common.gates] == [
        "Constant(num_consts=2)", "Arithmetic(num_ops=20)", "Poseidon(width=12)",
        "BaseSum(base=2,limbs=64)", "PublicInput", "Noop"]
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    proof = data.prove(inputs)
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert len(raw) == want["proof_len"]
    assert hashlib.sha256(raw).hexdigest() == want["proof_sha256"]
