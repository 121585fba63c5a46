"""The port's compile + prove path (`plonky2_tpu_torch`) against the JAX
package, end to end on small circuits.

The check is byte equality of `serialize_proof` output (tolerance 0): the
prover is deterministic integer arithmetic.  The port runs here on CPU
tensors, where its kernel wrappers take their plain torch versions; the
same path on the card is `chip_smoke.py`.

* the golden tiny circuit: same constants/sigmas cap as the JAX build, the
  proof sha256 of tests/golden_vectors.json, and the JAX verifier accepts
  the port's bytes;
* the JAX compile's arrays carried over (`convert.py`) give the same cap and
  the same proof bytes;
* the builder's gadget helpers (select, is_equal, le_sum, ...) give the
  JAX builder's gates, constants and copy classes, and the values they
  compute;
* `build()`, `compile_circuit()` and `grind()` run on the card unless the
  caller passes `device="cpu"`, as every test here does;
* a Poseidon chain under test_config (2^6 rows) gives the digest recorded
  in tests/torch_port_vectors.json; a `slow` test regenerates that fixture
  with the JAX package (scripts/make_torch_port_vectors.py).
"""
import dataclasses
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

from plonky2_tpu.ir import CircuitBuilder as JBuilder
from plonky2_tpu.ir import CircuitConfig as JConfig
from plonky2_tpu.serialization import deserialize_proof
from plonky2_tpu_torch import convert
from plonky2_tpu_torch.bench import build_poseidon_chain
from plonky2_tpu_torch.hashes import poseidon
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.serialization import serialize_proof

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


def _tiny(builder_cls, config_cls):
    """The circuit of tests/test_golden_vectors.py."""
    b = builder_cls(config_cls.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    z = b.mul_add(x, y, x)
    for t in b.two_to_one([x, y, z, x], [y, z, x, y]):
        b.register_public_input(t)
    return b, {x: 111, y: 222}


@pytest.fixture(scope="module")
def jax_tiny():
    b, inputs = _tiny(JBuilder, JConfig)
    return b.build(), inputs


@pytest.fixture(scope="module")
def port_tiny():
    b, inputs = _tiny(CircuitBuilder, CircuitConfig)
    data = b.build(device="cpu")
    return data, inputs, serialize_proof(data.prove(inputs))


def test_tiny_circuit_cs_cap_equals_jax(jax_tiny, port_tiny):
    jdata, _ = jax_tiny
    data, _, _ = port_tiny
    assert data.verifier.cs_cap == jdata.verifier.cs_cap
    assert data.common.degree_bits == jdata.common.degree_bits
    assert [g.key() for g in data.common.gates] == [g.key() for g in jdata.common.gates]


def test_tiny_circuit_proof_matches_golden(port_tiny):
    golden = _load("golden_vectors.json")
    _, _, raw = port_tiny
    assert len(raw) == golden["tiny_circuit_proof_len"]
    assert hashlib.sha256(raw).hexdigest() == golden["tiny_circuit_proof_sha256"]


def test_jax_verifier_accepts_port_proof(jax_tiny, port_tiny):
    jdata, _ = jax_tiny
    _, _, raw = port_tiny
    proof = deserialize_proof(raw)
    assert proof.public_inputs == _load("golden_vectors.json")["tiny_circuit_public_inputs"]
    jdata.verify(proof)
    proof.public_inputs[0] = (proof.public_inputs[0] + 1) % (2**64 - 2**32 + 1)
    with pytest.raises(AssertionError):
        jdata.verify(proof)


def test_conversion_roundtrip(jax_tiny, port_tiny):
    jdata, _ = jax_tiny
    data, inputs, raw = port_tiny
    jpd = jdata.prover
    arrays = convert.prover_arrays_from_numpy(
        np.asarray(jpd.selector_polys), np.asarray(jpd.constant_polys),
        np.asarray(jpd.sigma_polys), "cpu", data.common.config)
    for key in ("selector_polys", "constant_polys", "sigma_polys"):
        assert np.array_equal(convert.tensor_to_u64(getattr(data.prover, key)),
                              np.asarray(getattr(jpd, key)))
    assert np.array_equal(convert.tensor_to_u64(arrays["cs_lde"]), np.asarray(jpd.cs_lde))
    assert np.array_equal(convert.tensor_to_u64(arrays["cs_coeffs"]),
                          np.asarray(jpd.cs_coeffs))
    assert arrays["cs_tree"].cap_host() == jdata.verifier.cs_cap
    pd = dataclasses.replace(data.prover, **arrays)
    from plonky2_tpu_torch.prove import prove
    assert serialize_proof(prove(pd, inputs)) == raw
    u = np.asarray([0, 1, 2**63, 2**64 - 2**32], dtype=np.uint64)
    assert np.array_equal(convert.tensor_to_u64(convert.u64_to_tensor(u)), u)


def test_small_poseidon_chain_matches_fixture():
    want = _load("torch_port_vectors.json")["small_chain"]
    b, inputs, _ = build_poseidon_chain(6, CircuitConfig.test_config())
    assert b.num_gates() == want["num_gates"]
    data = b.build(device="cpu")
    assert data.common.degree_bits == want["degree_bits"]
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    proof = data.prove(inputs)
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert len(raw) == want["proof_len"]
    assert hashlib.sha256(raw).hexdigest() == want["proof_sha256"]


def _helpers_circuit(builder_cls, config_cls):
    """A circuit made of the builder's gadget helpers (no JAX compile: the
    check is on the builder graph, which fixes every compiled array)."""
    b = builder_cls(config_cls.test_config())
    x, y = b.add_virtual_targets(2)
    bits = b.add_virtual_targets(3)
    for t in bits:
        b.assert_bool(t)
    s = b.add_many([x, y, b.le_sum(bits)])
    sel = b.select(bits[0], x, y)
    eq = b.is_equal(x, y)
    ne = b.not_(eq)
    b.assert_one(b.or_(ne, eq))
    a = b.and_(bits[0], bits[2])
    h = b.hash_n_to_hash_no_pad([s, sel, a, x, y, eq, ne, *bits, x, y, s])
    b.register_public_inputs([s, sel, eq, ne, a] + h)
    return b, {x: 5, y: 7, bits[0]: 1, bits[1]: 0, bits[2]: 1}


def test_builder_helpers_match_jax_graph():
    jb, _ = _helpers_circuit(JBuilder, JConfig)
    b, inputs = _helpers_circuit(CircuitBuilder, CircuitConfig)
    assert [(g.key(), c) for g, c in b.gate_instances] == \
        [(g.key(), c) for g, c in jb.gate_instances]
    assert b.public_inputs == jb.public_inputs

    def classes(builder):
        out: dict = {}
        for t in set(builder._parent) | set(builder._parent.values()):
            out.setdefault(builder._find(t), []).append(repr(t))
        return sorted(sorted(c) for c in out.values())
    assert classes(b) == classes(jb)
    proof = b.build(device="cpu").prove(inputs)
    pis = proof.public_inputs
    assert pis[:5] == [5 + 7 + 5, 5, 0, 1, 1]
    assert pis[5:] == list(poseidon.hash_no_pad_s([17, 5, 1, 5, 7, 0, 1, 1, 0, 1,
                                                   5, 7, 17]))


@pytest.mark.slow
def test_fixture_regenerates_from_jax():
    # ~50 min on the CPU: the JAX package proves config 1 (2^12 rows),
    # config 2 (2^13 rows), config 3 (2^14 rows) and config 4 (2^16 rows;
    # its build and prove took 710 s, small_ecc's 531 s, most of that one
    # XLA compile of the quotient).
    path = os.path.join(os.path.dirname(HERE), "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.compute_vectors() == _load("torch_port_vectors.json")


def test_grind_witness_independent_of_batch_and_equal_jax():
    from plonky2_tpu.fri import grind as jgrind
    from plonky2_tpu.hashes import poseidon as jpos
    from plonky2_tpu.transcript import Challenger as JChallenger
    from plonky2_tpu_torch.fri import grind
    from plonky2_tpu_torch.transcript import Challenger
    ch, jch = Challenger(poseidon), JChallenger(jpos)
    for c in (ch, jch):
        c.observe_elements([5, 2**63 + 7, 11])
    # pow_bits 8: the default batch is 4096; smaller batches span many chunks
    w = grind(ch, 8, device="cpu")
    assert w == jgrind(jch, 8)
    assert grind(ch, 8, batch=100, device="cpu") == w
    assert grind(ch, 8, batch=37, device="cpu") == w
    ch.observe_element(w)
    assert ch.get_challenge() < 1 << 56


def test_entry_points_default_to_the_card():
    # Without a card, build(), compile_circuit() and grind() with no device
    # raise, and build() raises before it touches the circuit.
    import torch
    from plonky2_tpu_torch.fri import grind
    from plonky2_tpu_torch.prove.compile import compile_circuit
    from plonky2_tpu_torch.transcript import Challenger
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    b, _ = _tiny(CircuitBuilder, CircuitConfig)
    rows = b.num_gates()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_circuit(b)
    assert b.num_gates() == rows and not b._built
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grind(Challenger(poseidon), 8)


def test_poseidon_gate_eval_forms_agree():
    import jax.numpy as jnp
    import torch
    from plonky2_tpu.gates import PoseidonGate as JPoseidonGate
    from plonky2_tpu_torch.field import gl
    from plonky2_tpu_torch.gates import BatchAlg, EvalVars, PoseidonGate
    rng = np.random.RandomState(0x6A7E)
    wires = (rng.randint(0, 2**63, size=(135, 8), dtype=np.int64).astype(np.uint64)
             % np.uint64(gl.P))
    wires[24] = [0, 1, 0, 1, 2, 0, 1, 0]          # swap flag, one non-boolean
    gate, wt = PoseidonGate(), gl.to_tensor(wires)
    fast = gate.eval_batch_fast(wt, None, None)
    generic = gate.eval(EvalVars(list(wt), [], []), BatchAlg((8,), "cpu"))
    assert torch.equal(fast, torch.stack(generic))
    want = np.asarray(JPoseidonGate().eval_batch_fast(jnp.asarray(wires), None, None))
    assert np.array_equal(gl.from_tensor(fast), want)
