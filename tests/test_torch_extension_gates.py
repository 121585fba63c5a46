"""The port's extension, exponentiation and coset-interpolation gates
(`plonky2_tpu_torch.gates.extension`, `.exponentiation`,
`.coset_interpolation`), the builder methods that place them and the
`ext_inv` hint, against the JAX package.

Exact equality (tolerance 0): integer field arithmetic.

* each of the six new gate classes (ArithmeticExtension, MulExtension,
  and Reducing, ReducingExtension, Exponentiation and CosetInterpolation
  at two sizes each) has the JAX gate's key,
  shape, generator wiring and op spec; its generic `eval` under `BatchAlg`
  gives the JAX gate's values on random rows from a numpy seed, and is
  zero on rows its own generators filled (the `ExtAlg` case is in
  tests/test_torch_verifier.py, with the serde registry);
* the `ext_inv` hint equals the JAX hint;
* ports of tests/test_extension_gates.py and the exponentiation case of
  tests/test_new_gates.py: small circuits that check each builder method
  against the host field ops, proved and verified on the CPU;
* the port of tests/test_witness_tape.py::test_tape_extension_ops: the
  tape (with the `arith_ext`, `mul_ext`, `reduce` and `reduce_ext`
  opcodes) gives the dynamic scheduler's wire matrix;
* `small_ext` (every new builder method and the `ext_inv` hint, 2^4 rows
  under test_config) has the fixture's verifier-key, prover-data and
  wire-matrix digests, and its CPU proof has the fixture's bytes
  (scripts/make_torch_port_vectors.py, the JAX package's).
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

from plonky2_tpu.gates import coset_interpolation as jcoset
from plonky2_tpu.gates import exponentiation as jexp
from plonky2_tpu.gates import extension as jextension
from plonky2_tpu.gates.base import BatchAlg as JBatchAlg
from plonky2_tpu.gates.base import EvalVars as JEvalVars
from plonky2_tpu.ir import CircuitConfig as JCircuitConfig
from plonky2_tpu.witness.hints import HINTS as JHINTS
from plonky2_tpu_torch import ir
from plonky2_tpu_torch.field import ext, gl
from plonky2_tpu_torch.gates import (ArithmeticExtensionGate, BatchAlg,
                                     CosetInterpolationGate, EvalVars,
                                     ExponentiationGate, MulExtensionGate,
                                     ReducingExtensionGate, ReducingGate)
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.prove.prover import scheduler_witness_matrix, witness_matrix
from plonky2_tpu_torch.serialization import (serialize_proof, serialize_prover_data,
                                             serialize_verifier_data)
from plonky2_tpu_torch.witness.hints import HINTS

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


# ------------------------------------------------------------------
# the gates against their JAX twins
# ------------------------------------------------------------------

TEST_CONFIG, JTEST_CONFIG = CircuitConfig.test_config(), JCircuitConfig.test_config()
GATES = {
    "ArithmeticExtension": (ArithmeticExtensionGate.from_config(TEST_CONFIG),
                            jextension.ArithmeticExtensionGate.from_config(JTEST_CONFIG)),
    "MulExtension": (MulExtensionGate.from_config(TEST_CONFIG),
                     jextension.MulExtensionGate.from_config(JTEST_CONFIG)),
    "Reducing-3": (ReducingGate(3), jextension.ReducingGate(3)),
    "Reducing-max": (
        ReducingGate(ReducingGate.max_coeffs(TEST_CONFIG)),
        jextension.ReducingGate(jextension.ReducingGate.max_coeffs(JTEST_CONFIG))),
    "ReducingExtension-1": (ReducingExtensionGate(1), jextension.ReducingExtensionGate(1)),
    "ReducingExtension-max": (
        ReducingExtensionGate(ReducingExtensionGate.max_coeffs(TEST_CONFIG)),
        jextension.ReducingExtensionGate(
            jextension.ReducingExtensionGate.max_coeffs(JTEST_CONFIG))),
    "Exponentiation": (ExponentiationGate(7), jexp.ExponentiationGate(7)),
    "Exponentiation-1": (ExponentiationGate(1), jexp.ExponentiationGate(1)),
    "CosetInterpolation-2": (CosetInterpolationGate(2), jcoset.CosetInterpolationGate(2)),
    "CosetInterpolation-3": (CosetInterpolationGate(3), jcoset.CosetInterpolationGate(3)),
}
ROWS = 4
CONSTS = [5, gl.P - 3]


def _field(rng, shape):
    """uint64 values over all of [0, p), p - 1 in the first column."""
    hi = rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint64)
    lo = rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint64)
    v = ((hi << np.uint64(32)) | lo) % np.uint64(gl.P)
    v[..., 0] = gl.P - 1
    return v


def _valid_rows(gate, seed):
    """[num_wires, ROWS] uint64: each generator's deps from the seed (bits
    boolean, the coset shift nonzero), the rest from the generators."""
    rng = random.Random(seed)
    w = np.zeros((gate.num_wires, ROWS), dtype=np.uint64)
    bits = ({gate.wire_bit(i) for i in range(gate.num_power_bits)}
            if isinstance(gate, ExponentiationGate) else set())
    for r in range(ROWS):
        vals = {}
        for g in gate.generators(r, CONSTS):
            for d in g.deps:
                if d[1] not in vals:
                    vals[d[1]] = rng.randrange(2) if d[1] in bits else rng.randrange(1, gl.P)
            for wire, v in g.run(lambda t: vals[t[1]]):
                vals[wire[1]] = v
        for col, v in vals.items():
            w[col, r] = v
    return w


def _eval(gate, wires, consts):
    got = gate.eval(EvalVars(list(gl.to_tensor(wires)), list(gl.to_tensor(consts)), []),
                    BatchAlg((wires.shape[1],), "cpu"))
    return gl.from_tensor(torch.stack(got))


@pytest.mark.parametrize("name", list(GATES))
def test_batch_alg_eval_equals_jax(name):
    gate, jgate = GATES[name]
    assert (gate.key(), gate.num_wires, gate.num_constants, gate.degree,
            gate.num_constraints) == (jgate.key(), jgate.num_wires, jgate.num_constants,
                                      jgate.degree, jgate.num_constraints)
    for g, jg in zip(gate.generators(3, CONSTS), jgate.generators(3, CONSTS)):
        assert [tuple(d) for d in g.deps] == [tuple(d) for d in jg.deps]
        assert [tuple(o) for o in g.outs] == [tuple(o) for o in jg.outs]
        assert g.op == jg.op

    valid = _valid_rows(gate, 0xE4 + len(name))
    consts = np.asarray([[c] * ROWS for c in CONSTS], dtype=np.uint64)
    assert not _eval(gate, valid, consts).any()     # the generated rows satisfy

    rng = np.random.RandomState(0xE5 + len(name))
    wires = np.concatenate([valid, _field(rng, (gate.num_wires, 6))], axis=1)
    consts = np.concatenate([consts, _field(rng, (2, 6))], axis=1)
    jcs = jgate.eval(JEvalVars([jnp.asarray(r) for r in wires],
                               [jnp.asarray(c) for c in consts], []),
                     JBatchAlg((wires.shape[1],)))
    got = _eval(gate, wires, consts)
    assert got.shape == (gate.num_constraints, wires.shape[1])
    assert np.array_equal(got, np.stack([np.asarray(c) for c in jcs]))
    assert got[:, ROWS:].any()


def test_ext_inv_hint_equals_jax():
    rng = random.Random(0xE1)
    for v in [(1, 0), (0, 1), (gl.P - 1, gl.P - 1)] + [
            (rng.randrange(gl.P), rng.randrange(gl.P)) for _ in range(8)]:
        got = HINTS["ext_inv"]({}, list(v))
        assert got == JHINTS["ext_inv"]({}, list(v))
        assert ext.mul_s(v, tuple(got)) == ext.ONE


# ------------------------------------------------------------------
# the builder methods (ports of tests/test_extension_gates.py and the
# exponentiation case of tests/test_new_gates.py)
# ------------------------------------------------------------------

RNG = random.Random(0xE87)


def _rand_ext():
    return (RNG.randrange(gl.P), RNG.randrange(gl.P))


def _run(build_fn):
    b = CircuitBuilder(CircuitConfig.test_config())
    inputs = build_fn(b)
    data = b.build(device="cpu")
    proof = data.prove(inputs)
    data.verify(proof)
    return proof


def test_extension_arithmetic_circuit():
    def build(b):
        x, y, z = _rand_ext(), _rand_ext(), _rand_ext()
        xt, yt, zt = (b.constant_extension(v) for v in (x, y, z))
        checks = [
            (b.mul_extension(xt, yt), ext.mul_s(x, y)),
            (b.add_extension(xt, yt), ext.add_s(x, y)),
            (b.sub_extension(xt, yt), ext.sub_s(x, y)),
            (b.mul_add_extension(xt, yt, zt), ext.add_s(ext.mul_s(x, y), z)),
            (b.scalar_mul_ext(5, xt), ext.scalar_mul_s(x, 5)),
            (b.arithmetic_extension(3, 4, xt, yt, zt),
             ext.add_s(ext.scalar_mul_s(ext.mul_s(x, y), 3), ext.scalar_mul_s(z, 4))),
        ]
        for got, want in checks:
            b.connect_extension(got, b.constant_extension(want))
        return {}

    _run(build)


def test_coset_interpolation_circuit():
    def build(b):
        bits = 2
        n = 1 << bits
        g = gl.primitive_root_of_unity(bits)
        shift = RNG.randrange(1, gl.P)
        coeffs = [_rand_ext() for _ in range(n)]

        def poly_eval(x):
            acc = ext.ZERO
            for c in reversed(coeffs):
                acc = ext.add_s(ext.mul_s(acc, x), c)
            return acc

        values = [poly_eval(ext.from_base_s(shift * pow(g, i, gl.P) % gl.P))
                  for i in range(n)]
        z = _rand_ext()
        got = b.interpolate_coset(bits, b.constant(shift),
                                  [b.constant_extension(v) for v in values],
                                  b.constant_extension(z))
        b.connect_extension(got, b.constant_extension(poly_eval(z)))
        return {}

    _run(build)


def test_reducing_gates_circuit():
    def build(b):
        alpha = _rand_ext()
        at = b.constant_extension(alpha)
        # base-field fold, long enough to span several ReducingGate rows
        terms = [RNG.randrange(gl.P) for _ in range(23)]
        acc = ext.ZERO
        for t in terms:
            acc = ext.add_s(ext.mul_s(acc, alpha), ext.from_base_s(t))
        got = b.reduce_with_powers_ext(at, [b.constant(t) for t in terms])
        b.connect_extension(got, b.constant_extension(acc))
        # extension-field fold
        eterms = [_rand_ext() for _ in range(9)]
        eacc = ext.ZERO
        for t in eterms:
            eacc = ext.add_s(ext.mul_s(eacc, alpha), t)
        egot = b.reduce_with_powers_ext_circuit(
            at, [b.constant_extension(t) for t in eterms])
        b.connect_extension(egot, b.constant_extension(eacc))
        return {}

    _run(build)


def test_exponentiation_circuit():
    def build(b):
        for base, e in [(3, 0), (3, 1), (7, 41), (2, 63)]:
            got = b.exp_u64(b.constant(base), b.constant(e), 6)
            b.connect(got, b.constant(pow(base, e, gl.P)))
        return {}

    _run(build)


def test_tape_extension_ops():
    b = CircuitBuilder(CircuitConfig.test_config())
    a = b.add_virtual_extension_target()
    c = b.add_virtual_extension_target()
    alpha = b.add_virtual_extension_target()
    prod = b.mul_extension(a, c)                     # mul_ext opcode
    mixed = b.arithmetic_extension(3, 5, a, c, prod)  # arith_ext opcode
    base_terms = [b.add_virtual_target() for _ in range(5)]
    folded = b.reduce_with_powers_ext(alpha, base_terms)      # reduce
    folded2 = b.reduce_with_powers_ext_circuit(alpha, [a, c, mixed])
    for t in (*prod, *mixed, *folded, *folded2):
        b.register_public_input(t)
    inputs = {a[0]: 11, a[1]: 22, c[0]: 33, c[1]: 44, alpha[0]: 5, alpha[1]: 6}
    for i, t in enumerate(base_terms):
        inputs[t] = 100 + i
    pd = b.build(device="cpu").prover
    wires, store = witness_matrix(pd, inputs)
    want, dyn_store = scheduler_witness_matrix(pd, inputs)
    for rep, v in dyn_store._vals.items():
        assert store.get_or_zero(rep) == v, rep
    assert np.array_equal(wires, want)
    assert [store.get(t) for t in prod] == list(ext.mul_s((11, 22), (33, 44)))


# ------------------------------------------------------------------
# small_ext: the JAX package's bytes
# ------------------------------------------------------------------

def test_small_ext_proof_equals_jax():
    gen = _vector_script()
    want = _fixture("small_ext")
    b, inputs = gen.small_ext(ir)
    assert b.num_gates() == want["num_gates"]
    data = b.build(device="cpu")
    assert data.common.degree_bits == want["degree_bits"]
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    assert hashlib.sha256(serialize_verifier_data(data.verifier)).hexdigest() == \
        want["verifier_data_sha256"]
    assert hashlib.sha256(serialize_prover_data(data.prover)).hexdigest() == \
        want["prover_data_sha256"]
    wires, _ = witness_matrix(data.prover, inputs)
    assert gen.wire_matrix_sha256(wires) == want["wire_matrix_sha256"]
    proof = data.prove(inputs)
    data.verify(proof)
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert (len(raw), hashlib.sha256(raw).hexdigest()) == \
        (want["proof_len"], want["proof_sha256"])
