"""The port's recursion (`plonky2_tpu_torch.recursion`), zkDSA
(`plonky2_tpu_torch.zkdsa`) and aggregation (`plonky2_tpu_torch.zkaa`,
`bench.build_aggregation`) modules against the JAX package.

Exact equality (tolerance 0): integer field arithmetic and byte formats.

* ports of tests/test_recursion.py: `CircuitAlg` (gate constraints emitted
  as circuit rows) agrees with `ExtAlg` on the host, the in-circuit Merkle
  path verifies a tree's opening, and the in-circuit challenger replays
  the host challenger (each circuit proved and verified on the CPU);
* ports of tests/test_zkdsa.py: address serde, account derivation (equal
  to the JAX package's), the typed public inputs, the signature circuit
  and the address gadget;
* `small_recursion` (the inner circuit of tests/test_recursion_e2e.py and
  the outer circuit that verifies its proof): the inner proof has the
  fixture's bytes, the outer builder's graph digest (before any build)
  equals the fixture's, and `set_proof_witness` binds the inner proof
  read back by the port's serde to the values the JAX package binds;
* config 5 (`build_aggregation(4)`): its own steps
  (`bench.circuits.aggregation_steps`) for one proof give the inner zkDSA
  circuit's key and first proof the fixture's digests, and the outer
  builder of four slots has the fixture's graph digest (the 2^13-row
  outer circuit is built and proved on the card, by chip_smoke.py, not
  here).
"""
import hashlib
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

from plonky2_tpu import ir as jir
from plonky2_tpu import zkdsa as jzkdsa
from plonky2_tpu.recursion import add_virtual_proof_target as jadd_virtual_proof_target
from plonky2_tpu.recursion import set_proof_witness as jset_proof_witness
from plonky2_tpu.serialization import deserialize_proof as jdeserialize_proof
from plonky2_tpu.serialization import deserialize_verifier_data as jdeserialize_vd
from plonky2_tpu_torch import ir, zkaa
from plonky2_tpu_torch.bench.circuits import AGGREGATION_SEED, aggregation_steps
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.gadgets.smt import set_hash_witness
from plonky2_tpu_torch.hashes import poseidon
from plonky2_tpu_torch.gates import (ArithmeticGate, BaseSumGate, ConstantGate,
                                     EvalVars, ExtAlg, ReducingGate)
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.ir.digest import graph_digest
from plonky2_tpu_torch.merkle.merkle import MerkleTree, verify_merkle_proof_s
from plonky2_tpu_torch.recursion import (RecursiveChallenger, add_proof_verification,
                                         set_proof_witness,
                                         verify_merkle_proof_to_cap_circuit)
from plonky2_tpu_torch.recursion.circuit_alg import eval_gate_constraints_circuit
from plonky2_tpu_torch.serialization import (deserialize_proof, serialize_proof,
                                             serialize_verifier_data)
from plonky2_tpu_torch.smt.hash_out import ZERO_HASH
from plonky2_tpu_torch.transcript.challenger import Challenger
from plonky2_tpu_torch.zkdsa import (Account, Address, AddressTarget,
                                     SimpleSignaturePublicInputs,
                                     make_simple_signature_circuit,
                                     private_key_to_account)
from plonky2_tpu_torch.zkdsa.account import sign_message

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RNG = random.Random(0x2EC)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU proves here are many small ops: one thread avoids contention
    # with the other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vector_script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _vector_script()


def _fixture(name):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[name]


def _rand_ext():
    return (RNG.randrange(gl.P), RNG.randrange(gl.P))


def _run(build_fn):
    b = CircuitBuilder(CircuitConfig.test_config())
    inputs = build_fn(b)
    data = b.build(device="cpu")
    proof = data.prove(inputs)
    data.verify(proof)
    return proof


# ------------------------------------------------------------------
# recursion building blocks (port of tests/test_recursion.py)
# ------------------------------------------------------------------

def test_circuit_alg_matches_ext_alg():
    gates = [ArithmeticGate(2), ConstantGate(3), BaseSumGate(2, 6), ReducingGate(3)]

    def build(b):
        for gate in gates:
            wires = [_rand_ext() for _ in range(gate.num_wires)]
            consts = [_rand_ext() for _ in range(max(gate.num_constants, 2))]
            pi = [_rand_ext() for _ in range(4)]
            host = gate.eval(EvalVars(list(wires), list(consts), list(pi)), ExtAlg())
            got = eval_gate_constraints_circuit(
                b, gate,
                [b.constant_extension(w) for w in wires],
                [b.constant_extension(c) for c in consts],
                [b.constant_extension(p) for p in pi])
            assert len(got) == gate.num_constraints
            for g, h in zip(got, host):
                b.connect_extension(g, b.constant_extension(h))
        return {}

    _run(build)


def test_merkle_proof_circuit():
    L, C, cap_height = 16, 6, 1
    leaves = np.array([[RNG.randrange(gl.P) for _ in range(L)] for _ in range(C)],
                      dtype=np.uint64)
    tree = MerkleTree.build_cols(gl.to_tensor(leaves), cap_height, poseidon)
    cap = tree.cap_host()
    index = 11
    leaf, sibs = tree.open_many([index])
    leaf = [int(v) for v in leaf[0]]
    siblings = [[int(x) for x in s] for s in sibs[0]]
    assert verify_merkle_proof_s(leaf, index, cap, siblings, poseidon)

    def build(b):
        bits = [b.constant((index >> i) & 1) for i in range(4)]
        verify_merkle_proof_to_cap_circuit(
            b, [b.constant(v) for v in leaf], bits,
            [[b.constant(x) for x in h] for h in cap],
            [[b.constant(x) for x in s] for s in siblings])
        return {}

    _run(build)


def test_recursive_challenger_matches_host():
    def build(b):
        host = Challenger(poseidon)
        circ = RecursiveChallenger(b)
        xs = [RNG.randrange(gl.P) for _ in range(13)]  # crosses a duplex
        host.observe_elements(xs)
        circ.observe_elements([b.constant(x) for x in xs])
        for c, t in zip(host.get_n_challenges(3), circ.get_n_challenges(3)):
            b.connect(t, b.constant(c))
        host.observe_element(7)          # partial absorb before next draw
        circ.observe_element(b.constant(7))
        e_host = host.get_ext_challenge()
        e_circ = circ.get_ext_challenge()
        b.connect_extension(e_circ, b.constant_extension(e_host))
        return {}

    _run(build)


# ------------------------------------------------------------------
# zkDSA (port of tests/test_zkdsa.py)
# ------------------------------------------------------------------

ZRNG = random.Random(0xD5A)


def _rand_hash():
    return tuple(ZRNG.randrange(gl.P) for _ in range(4))


def test_address_hex_serde():
    a = Address(1)
    assert a.to_hex() == "0x0000000000000001"
    assert Address.from_hex("0x01") == a
    for _ in range(5):
        a = Address(ZRNG.randrange(gl.P))
        s = a.to_hex()
        assert len(s) == 18
        assert Address.from_hex(s) == a
        assert s == jzkdsa.Address(a.value).to_hex()
    for bad in ("01", "0x" + "ff" * 9, "0xffffffffffffffff"):
        with pytest.raises(ValueError):
            Address.from_hex(bad)


def test_address_hash_out_roundtrip():
    a = Address(ZRNG.randrange(gl.P))
    h = a.to_hash_out()
    assert h[1:] == (0, 0, 0)
    assert Address.from_hash_out(h) == a
    out = []
    a.write(out)
    assert Address.read(iter(out)) == a
    with pytest.raises(ValueError):
        Address.from_hash_out((1, 2, 0, 0))


def test_account_derivation_equals_jax():
    for _ in range(4):
        sk = _rand_hash()
        acct = private_key_to_account(sk)
        assert acct == Account.new(sk)
        assert acct.address.value == acct.public_key[0]
        jacct = jzkdsa.private_key_to_account(sk)
        assert (acct.public_key, acct.address.value) == \
            (tuple(jacct.public_key), jacct.address.value)
        msg = _rand_hash()
        assert sign_message(sk, msg) == tuple(jzkdsa.account.sign_message(sk, msg))


def test_default_public_inputs_self_consistent():
    d = SimpleSignaturePublicInputs.default()
    assert d.message == ZERO_HASH
    # with message = 0, signature = H(sk, 0) = H(0, 0) = public_key
    assert d.signature == d.public_key
    assert SimpleSignaturePublicInputs.decode(d.encode()) == d
    assert d.encode() == jzkdsa.SimpleSignaturePublicInputs.default().encode()


def test_simple_signature_circuit():
    circuit = make_simple_signature_circuit(CircuitConfig.test_config(), device="cpu")
    sk, msg = _rand_hash(), _rand_hash()
    proof = circuit.prove(sk, msg)
    circuit.verify(proof)
    acct = private_key_to_account(sk)
    assert proof.public_inputs.message == msg
    assert proof.public_inputs.public_key == acct.public_key
    assert proof.public_inputs.signature == sign_message(sk, msg)
    # a different key yields a different signature over the same message
    proof2 = circuit.prove(_rand_hash(), msg)
    assert proof2.public_inputs.signature != proof.public_inputs.signature


def test_address_target_constrains_padding():
    b = CircuitBuilder(CircuitConfig.test_config())
    t = AddressTarget.add_virtual_to(b)
    b.register_public_inputs(t.elements)
    data = b.build(device="cpu")
    a = Address(ZRNG.randrange(gl.P))
    pw = {}
    t.set_witness(pw, a)
    proof = data.prove(pw)
    data.verify(proof)
    assert proof.public_inputs == [a.value, 0, 0, 0]
    # a nonzero padding element is rejected
    pw = {}
    set_hash_witness(pw, t.elements, (a.value, 5, 0, 0))
    with pytest.raises(ValueError):
        data.prove(pw)


# ------------------------------------------------------------------
# the fixture's recursion entries, without an outer build
# ------------------------------------------------------------------

def _proof_digest(proof) -> str:
    return hashlib.sha256(serialize_proof(proof)).hexdigest()


def test_small_recursion_graph_and_witness_equal_jax():
    want = _fixture("small_recursion")
    b, inputs = GEN.recursion_inner(ir)
    data = b.build(device="cpu")
    proof = data.prove(inputs)
    raw = serialize_proof(proof)
    assert hashlib.sha256(raw).hexdigest() == want["inner"]["proof_sha256"]
    assert hashlib.sha256(serialize_verifier_data(data.verifier)).hexdigest() == \
        want["inner"]["verifier_data_sha256"]

    bo = CircuitBuilder(CircuitConfig.test_config())
    pt = add_proof_verification(bo, data.verifier)
    bo.register_public_inputs(pt.public_inputs)
    assert bo.num_gates() == want["outer"]["num_gates"]
    assert graph_digest(bo) == want["outer"]["graph_sha256"]

    # the inner proof's bytes, read back, bind the values the JAX package
    # binds to the same targets (both builders allocate the proof's targets
    # first, from target 0)
    got: dict = {}
    set_proof_witness(got, pt, deserialize_proof(raw))
    jvd = jdeserialize_vd(serialize_verifier_data(data.verifier))
    jpt = jadd_virtual_proof_target(jir.CircuitBuilder(jir.CircuitConfig.test_config()),
                                    jvd.common)
    want_inputs: dict = {}
    jset_proof_witness(want_inputs, jpt, jdeserialize_proof(raw))
    assert len(got) > 1000 and got == want_inputs


def test_config5_inner_proof_and_outer_graph_equal_jax():
    want = _fixture("config5")
    # build_aggregation's own steps for one proof: the seed's first key and
    # message proved and verified, then a one-slot outer circuit traced
    inner, proofs, b1, pts1 = aggregation_steps(random.Random(AGGREGATION_SEED), 1, "cpu")
    assert hashlib.sha256(serialize_verifier_data(inner.data.verifier)).hexdigest() == \
        want["inner"]["verifier_data_sha256"]
    assert _proof_digest(proofs[0]) == want["inner"]["proof_sha256"][0]
    assert list(proofs[0].public_inputs) == want["inner"]["public_inputs"][0]
    assert len(pts1) == 1 and b1.num_gates() < want["outer"]["num_gates"]
    assert len(zkaa.aggregation_witness(pts1, proofs)) > 1000
    with pytest.raises(ValueError):
        zkaa.aggregation_witness(pts1, proofs * 2)

    b, pts = zkaa.aggregation_builder(inner.data.verifier, 4, inner.data.common.config)
    assert len(pts) == 4
    assert b.num_gates() == want["outer"]["num_gates"]
    assert graph_digest(b) == want["outer"]["graph_sha256"]
