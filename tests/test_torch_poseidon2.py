"""The port's Poseidon2 (`plonky2_tpu_torch.hashes.poseidon2`,
`plonky2_tpu_torch.gates.poseidon2_gate`) and the in-circuit hasher choice
of `CircuitConfig`, against the JAX package.

Exact equality (tolerance 0): integer field arithmetic.

* the round constants, the internal diagonal and the matrices M_E and M_I
  equal the JAX module's;
* `permute_s`, the batched `permute` and `hash_no_pad`, and the scalar
  sponges equal the JAX functions on states from a seed, lanes at or
  above 2^63 included;
* `Poseidon2Gate.eval_batch_fast` and its generic `eval` equal the JAX
  gate's on random wires, and are zero on rows its generator filled; the
  generator equals the JAX generator;
* `small_poseidon2` (tests/test_poseidon2.py's circuit oracle: one
  two_to_one under test_config with the Poseidon2 in-circuit hasher) has
  the fixture's verifier-key, prover-data and wire-matrix digests, and its
  CPU proofs from the built and the loaded circuit have the fixture's
  bytes (scripts/make_torch_port_vectors.py, the JAX package's).
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

from plonky2_tpu.gates import poseidon2_gate as jp2g
from plonky2_tpu.gates.base import BatchAlg as JBatchAlg
from plonky2_tpu.gates.base import EvalVars as JEvalVars
from plonky2_tpu.hashes import poseidon2 as jp2
from plonky2_tpu_torch import ir
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.gates import BatchAlg, EvalVars, Poseidon2Gate
from plonky2_tpu_torch.gates.poseidon2_gate import Poseidon2Generator
from plonky2_tpu_torch.hashes import poseidon, poseidon2 as p2
from plonky2_tpu_torch.prove.prover import scheduler_witness_matrix, witness_matrix
from plonky2_tpu_torch.serialization import (deserialize_prover_data,
                                             deserialize_verifier_data, serialize_proof,
                                             serialize_prover_data, serialize_verifier_data)
from plonky2_tpu_torch.witness.tape import OP_PY, build_tape

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


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


def _fixture(name):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[name]


def _states(seed, n):
    """n width-12 states over [0, p), the first with every lane >= 2^63."""
    rng = random.Random(seed)
    out = [[rng.randrange(1 << 63, gl.P) for _ in range(12)]]
    out += [[rng.randrange(gl.P) for _ in range(12)] for _ in range(n - 1)]
    return out


def test_constants_and_matrices_equal_jax():
    assert p2.EXTERNAL_RCS == jp2.EXTERNAL_RCS
    assert p2.INTERNAL_RCS == jp2.INTERNAL_RCS
    assert p2.INTERNAL_DIAG == jp2.INTERNAL_DIAG
    assert p2.M_E == jp2.M_E
    assert p2.M_I == jp2.M_I
    t = p2.tensors("cpu")
    assert gl.from_tensor(t["me"]).tolist() == p2.M_E
    assert gl.from_tensor(t["mi"]).tolist() == p2.M_I


def test_permute_s_equals_jax():
    for s in _states(0xB0, 5):
        assert p2.permute_s(s) == jp2.permute_s(s)
    assert p2.permute_s(_states(1, 1)[0]) != poseidon.permute_s(_states(1, 1)[0])


@pytest.mark.parametrize("shape", [(5,), (2, 3)])
def test_permute_equals_jax(shape):
    n = int(np.prod(shape))
    states = np.asarray(_states(0xB1 + n, n), dtype=np.uint64).reshape(shape + (12,))
    got = gl.from_tensor(p2.permute(gl.to_tensor(states)))
    want = np.asarray(jp2.permute(jnp.asarray(states)))
    assert got.shape == states.shape
    assert np.array_equal(got, want)


def test_sponges_equal_jax():
    rng = random.Random(0xB2)
    for width in (3, 17):
        rows = np.asarray([[rng.randrange(gl.P) for _ in range(width)] for _ in range(4)],
                          dtype=np.uint64)
        got = gl.from_tensor(p2.hash_no_pad(gl.to_tensor(rows)))
        assert np.array_equal(got, np.asarray(jp2.hash_no_pad(jnp.asarray(rows))))
        for row in rows.tolist():
            assert p2.hash_no_pad_s(row) == jp2.hash_no_pad_s(row)
            assert p2.hash_pad_s(row) == jp2.hash_pad_s(row)
            assert p2.hash_or_noop_s(row) == jp2.hash_or_noop_s(row)
            assert p2.hash_n_to_m_no_pad_s(row, 11) == jp2.hash_n_to_m_no_pad_s(row, 11)
    x, y = _states(0xB3, 1)[0][:4], _states(0xB4, 1)[0][:4]
    assert p2.two_to_one_s(x, y) == jp2.two_to_one_s(x, y)


# ------------------------------------------------------------------
# the gate
# ------------------------------------------------------------------

ROWS = 3


def _generated_rows(gen_cls, seed):
    """[135, ROWS] uint64: random inputs and swap flags, every other wire
    from the generator."""
    rng = random.Random(seed)
    w = np.zeros((135, ROWS), dtype=np.uint64)
    for r in range(ROWS):
        vals = {c: rng.randrange(gl.P) for c in range(12)}
        vals[24] = r % 2
        for wire, v in gen_cls(r).run(lambda t: vals[t[1]]):
            vals[wire[1]] = v
        for col, v in vals.items():
            w[col, r] = v
    return w


def _wires():
    rng = np.random.RandomState(0xB5)
    hi = rng.randint(0, 2**32, size=(135, 5), dtype=np.int64).astype(np.uint64)
    lo = rng.randint(0, 2**32, size=(135, 5), dtype=np.int64).astype(np.uint64)
    noise = ((hi << np.uint64(32)) | lo) % np.uint64(gl.P)
    noise[:, 0] = gl.P - 1
    return np.concatenate([_generated_rows(Poseidon2Generator, 0xB6), noise], axis=1)


def test_gate_shape_and_generator_equal_jax():
    gate, jgate = Poseidon2Gate(), jp2g.Poseidon2Gate()
    assert (gate.key(), gate.num_wires, gate.num_constants, gate.degree,
            gate.num_constraints) == (jgate.key(), jgate.num_wires, jgate.num_constants,
                                      jgate.degree, jgate.num_constraints)
    g, jg = gate.generators(3, [])[0], jgate.generators(3, [])[0]
    assert [tuple(d) for d in g.deps] == [tuple(d) for d in jg.deps]
    assert [tuple(o) for o in g.outs] == [tuple(o) for o in jg.outs]
    rng = random.Random(0xB7)
    vals = {c: rng.randrange(gl.P) for c in range(12)}
    vals[24] = 1
    got = g.run(lambda t: vals[t[1]])
    assert [(tuple(w), v) for w, v in got] == \
        [(tuple(w), v) for w, v in jg.run(lambda t: vals[t[1]])]


def test_gate_eval_batch_fast_equals_jax():
    wires = _wires()
    got = gl.from_tensor(Poseidon2Gate().eval_batch_fast(gl.to_tensor(wires), None, None))
    want = np.asarray(jp2g.Poseidon2Gate().eval_batch_fast(jnp.asarray(wires), None, None))
    assert got.shape == (Poseidon2Gate().num_constraints, wires.shape[1])
    assert np.array_equal(got, want)
    assert not got[:, :ROWS].any()          # the generated rows satisfy
    assert got[:, ROWS:].any()


def test_gate_generic_eval_equals_jax():
    wires = _wires()
    cs = Poseidon2Gate().eval(EvalVars(list(gl.to_tensor(wires)), [], []),
                              BatchAlg((wires.shape[1],), "cpu"))
    got = gl.from_tensor(torch.stack(cs))
    jcs = jp2g.Poseidon2Gate().eval(JEvalVars([jnp.asarray(r) for r in wires], [], []),
                                    JBatchAlg((wires.shape[1],)))
    assert np.array_equal(got, np.stack([np.asarray(c) for c in jcs]))
    fast = gl.from_tensor(Poseidon2Gate().eval_batch_fast(gl.to_tensor(wires), None, None))
    assert np.array_equal(got, fast)


# ------------------------------------------------------------------
# a Poseidon2-config circuit against the fixture
# ------------------------------------------------------------------

@pytest.mark.parametrize("config, key", [
    (ir.CircuitConfig.poseidon2_config(), "Poseidon2(width=12)"),
    (ir.CircuitConfig(), "Poseidon(width=12)")])
def test_builder_picks_the_gate_by_config(config, key):
    b = ir.CircuitBuilder(config)
    b.two_to_one(b.add_virtual_targets(4), b.add_virtual_targets(4))
    assert [g.key() for g, _ in b.gate_instances if "Poseidon" in g.key()] == [key]
    assert ir.CircuitConfig.poseidon2_config().hasher_module() is p2
    assert ir.CircuitConfig().hasher_module() is poseidon


def test_small_poseidon2_proof_equals_jax():
    want = _fixture("small_poseidon2")
    b, inputs = _vector_script().small_poseidon2(ir)
    data = b.build(device="cpu")
    assert data.common.degree_bits == want["degree_bits"]
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    vk = serialize_verifier_data(data.verifier)
    assert hashlib.sha256(vk).hexdigest() == want["verifier_data_sha256"]
    assert serialize_verifier_data(deserialize_verifier_data(vk)) == vk
    assert deserialize_verifier_data(vk).common.config.algebraic_hasher == "poseidon2"

    # the tape runs the Poseidon2 generator as a Python escape, as JAX's does
    tape = build_tape(data.prover)
    p2_ops = [tape.code[k] for k, gi in enumerate(tape.op_gen)
              if isinstance(tape.gens[gi], Poseidon2Generator)]
    assert p2_ops and set(p2_ops) == {OP_PY}
    wires, _ = witness_matrix(data.prover, inputs)
    assert np.array_equal(wires, scheduler_witness_matrix(data.prover, inputs)[0])
    assert hashlib.sha256(np.ascontiguousarray(wires, dtype="<u8").tobytes()).hexdigest() \
        == want["wire_matrix_sha256"]

    proof = data.prove(inputs)
    data.verify(proof)
    x = [inputs[t] for t in list(inputs)[:4]]
    y = [inputs[t] for t in list(inputs)[4:]]
    assert proof.public_inputs == p2.two_to_one_s(x, y) == want["public_inputs"]
    raw = serialize_proof(proof)
    assert (len(raw), hashlib.sha256(raw).hexdigest()) == \
        (want["proof_len"], want["proof_sha256"])

    blob = serialize_prover_data(data.prover)
    assert hashlib.sha256(blob).hexdigest() == want["prover_data_sha256"]
    loaded = deserialize_prover_data(blob, "cpu")
    assert serialize_proof(loaded.prove(inputs)) == raw
