"""The port's u32 gates and gadgets (`plonky2_tpu_torch.gates.u32_arithmetic`,
`gates.comparison`, `gates.u32_interleave`, `gadgets.u32`,
`bench.build_u32_mix`) against the JAX package.

Exact equality (tolerance 0): integer field arithmetic.

* each u32 gate on rows made from a numpy seed, with x and y near 2^32 - 1:
  its generators and `aux_fill` give the JAX gate's wires, those rows
  satisfy every constraint, and on those rows and on random rows its
  `eval_batch_fast` (or, for the comparison gates, its generic `eval`)
  gives the JAX values and equals its own generic `eval`;
* the builder's u32 gadgets give the JAX builder's gates, constants and
  copy classes, and the port's witness gives their values;
* config 2's u32 loop under test_config (2^7 rows): the same graph as the
  JAX builder's, the `small_u32` proof and verifier key of
  tests/torch_port_vectors.json, and the port's verifier accepts that
  proof and rejects it tampered.
"""
import copy
import hashlib
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plonky2_tpu.gadgets  # noqa: F401  (attaches the JAX u32 builder API)
import plonky2_tpu_torch.gadgets  # noqa: F401  (attaches the port's)
from plonky2_tpu import ir as jir
from plonky2_tpu.gates import comparison as jcmp
from plonky2_tpu.gates import u32_arithmetic as jarith
from plonky2_tpu.gates import u32_interleave as jil
from plonky2_tpu.gates.base import BatchAlg as JBatchAlg
from plonky2_tpu.gates.base import EvalVars as JEvalVars
from plonky2_tpu_torch.bench import build_u32_mix
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.gates import (BatchAlg, ComparisonGate, EvalVars,
                                     U32AddManyGate, U32ArithmeticGate,
                                     U32InterleaveGate, U32RangeCheckGate,
                                     U32SubtractionGate, UninterleaveToB32Gate,
                                     UninterleaveToU32Gate)
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.serialization import (serialize_proof,
                                             serialize_verifier_data)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU proves here are many small ops: one thread avoids contention
    # with the other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (port gate, JAX gate) pairs, two ops a row each (config 2's widths are in
# the small_u32 circuit below): shapes repeat across gates, so the JAX
# package compiles its field ops fewer times.
GATES = {
    "U32Arithmetic": (U32ArithmeticGate(2), jarith.U32ArithmeticGate(2)),
    "U32AddMany4": (U32AddManyGate(4, 2), jarith.U32AddManyGate(4, 2)),
    "U32AddMany13": (U32AddManyGate(13, 2), jarith.U32AddManyGate(13, 2)),
    "U32RangeCheck": (U32RangeCheckGate(2), jarith.U32RangeCheckGate(2)),
    "U32Subtraction": (U32SubtractionGate(2), jcmp.U32SubtractionGate(2)),
    "Comparison": (ComparisonGate(32), jcmp.ComparisonGate(32)),
    "U32Interleave": (U32InterleaveGate(2), jil.U32InterleaveGate(2)),
    "UninterleaveToU32": (UninterleaveToU32Gate(2), jil.UninterleaveToU32Gate(2)),
    "UninterleaveToB32": (UninterleaveToB32Gate(2), jil.UninterleaveToB32Gate(2)),
}

VALID, RANDOM = 6, 10          # rows made by the generators, random rows


def _near_max(rng) -> int:
    """A u32 near 2^32 - 1, or now and then any u32."""
    if rng.randint(4) == 0:
        return int(rng.randint(0, 2**32, dtype=np.int64))
    return 2**32 - 1 - int(rng.randint(0, 3))


def _interleave(x: int) -> int:
    return sum(((x >> j) & 1) << (2 * j) for j in range(32))


def _inputs(gate, rng) -> dict:
    """{wire: value} of the routed inputs of every op of one row."""
    name = type(gate).__name__
    if name == "ComparisonGate":
        return {gate.WIRE_A: _near_max(rng), gate.WIRE_B: _near_max(rng)}
    vals = {}
    for i in range(gate.num_ops):
        ws = gate.wires_op(i)
        if name in ("U32ArithmeticGate",):
            for k in ("x", "y", "z"):
                vals[ws[k]] = _near_max(rng)
        elif name == "U32AddManyGate":
            for j in range(gate.num_addends):
                vals[ws["addends"] + j] = _near_max(rng)
            vals[ws["carry_in"]] = int(rng.randint(2))
        elif name == "U32SubtractionGate":
            vals[ws["x"]], vals[ws["y"]] = _near_max(rng), _near_max(rng)
            vals[ws["borrow_in"]] = int(rng.randint(2))
        elif name in ("U32RangeCheckGate", "U32InterleaveGate"):
            vals[ws["x"]] = _near_max(rng)
        else:                       # uninterleave: a sum of two interleaved u32s
            vals[ws["x"]] = _interleave(_near_max(rng)) + _interleave(_near_max(rng))
    return vals


def _witness_rows(gate, rng_seed: int):
    """[num_wires, VALID] uint64: inputs from the seed, the rest from the
    gate's generators, then its aux_fill."""
    rng = np.random.RandomState(rng_seed)
    w = np.zeros((gate.num_wires, VALID), dtype=np.uint64)
    for r in range(VALID):
        vals = _inputs(gate, rng)
        for g in gate.generators(r, []):
            for wire, v in g.run(lambda t: vals[t[1]]):
                vals[wire[1]] = v
        for c, v in vals.items():
            w[c, r] = v
    if hasattr(gate, "aux_fill"):
        gate.aux_fill(np.arange(VALID, dtype=np.int64), w)
    return w


def _random_rows(num_wires: int, seed: int):
    """Random rows: values over [0, p), near 2^32 - 1 and small (limbs, bits
    and non-boolean values)."""
    rng = np.random.RandomState(seed)
    hi = rng.randint(0, 2**32, size=(num_wires, RANDOM), dtype=np.int64).astype(np.uint64)
    lo = rng.randint(0, 2**32, size=(num_wires, RANDOM), dtype=np.int64).astype(np.uint64)
    w = ((hi << np.uint64(32)) | lo) % np.uint64(gl.P)
    kind = rng.randint(0, 3, size=w.shape)
    near = np.uint64(2**32 - 1) - rng.randint(0, 3, size=w.shape).astype(np.uint64)
    small = rng.randint(0, 5, size=w.shape).astype(np.uint64)
    w[kind == 1] = near[kind == 1]
    w[kind == 2] = small[kind == 2]
    w[:, 0] = gl.P - 1
    return w


def _jax_constraints(jgate, wires):
    if hasattr(jgate, "eval_batch_fast"):
        cs = jgate.eval_batch_fast(jnp.asarray(wires), None, None)
    else:
        cs = jgate.eval(JEvalVars([jnp.asarray(r) for r in wires], [], []),
                        JBatchAlg((wires.shape[1],)))
    return np.stack([np.asarray(c) for c in cs])


@pytest.mark.parametrize("name", list(GATES))
def test_u32_gate_generators_and_aux_fill_equal_jax(name):
    gate, jgate = GATES[name]
    assert gate.key() == jgate.key()
    assert (gate.num_wires, gate.degree, gate.num_constraints) == \
        (jgate.num_wires, jgate.degree, jgate.num_constraints)
    w = _witness_rows(gate, 0x32)
    assert np.array_equal(w, _witness_rows(jgate, 0x32))
    for g, jg in zip(gate.generators(5, []), jgate.generators(5, [])):
        assert [tuple(d) for d in g.deps] == [tuple(d) for d in jg.deps]
        assert [tuple(o) for o in g.outs] == [tuple(o) for o in jg.outs]


@pytest.mark.parametrize("name", list(GATES))
def test_u32_gate_constraints_equal_jax(name):
    gate, jgate = GATES[name]
    valid = _witness_rows(gate, 0x33)
    wires = np.concatenate([valid, _random_rows(gate.num_wires, 0x34)], axis=1)
    wt = gl.to_tensor(wires)
    generic = torch.stack(gate.eval(EvalVars(list(wt), [], []),
                                    BatchAlg((wires.shape[1],), "cpu")))
    got = gate.eval_batch_fast(wt, None, None) if hasattr(gate, "eval_batch_fast") \
        else generic
    assert hasattr(gate, "eval_batch_fast") == hasattr(jgate, "eval_batch_fast")
    assert torch.equal(got, generic)
    assert got.shape == (gate.num_constraints, wires.shape[1])
    assert np.array_equal(gl.from_tensor(got), _jax_constraints(jgate, wires))
    assert not gl.from_tensor(got)[:, :VALID].any()       # the witness satisfies
    assert gl.from_tensor(got)[:, VALID:].any()


def _gadgets_circuit(builder_cls, config_cls):
    """Every u32 gadget once; the outputs are public inputs."""
    b = builder_cls(config_cls.test_config())
    x, y, z = (b.add_virtual_u32_target() for _ in range(3))
    flag = b.add_virtual_target()
    b.assert_bool(flag)
    outs = [*b.mul_add_u32(x, y, z), *b.add_u32(x, y), *b.sub_u32(x, y, b.one_u32()),
            b.add_many_u32([x, y, z, x, y])[0], b.add_many_u32([x] * 15)[1],
            b.not_u32(x), b.lsh_u32(x, 5), b.rsh_u32(x, 7), b.lrot_u32(x, 9),
            b.rrot_u32(y, 3), b.and_u32(x, y), b.xor_u32(x, y),
            b.unsafe_xor_many_u32([x, y, z, x]), b.unsafe_xor_many_u32([x, y, z, y, z]),
            b.conditional_u32(x, y, flag), *b.lrot_u64([x, y], 40),
            *b.xor_u64([x, y], [z, x]), *b.and_u64([x, y], [z, x]),
            *b.not_u64([y, z]), *b.conditional_u64([x, y], [z, x], flag),
            b.constant_u32(0xDEADBEEF)]
    lt = b.is_less_than_u32(x, y)
    le = b.le_compare(x.target, y.target)
    b.register_public_inputs([o.target for o in outs] + [lt, le])
    return b, {x.target: 0xFFFFFFFE, y.target: 0x89ABCDEF, z.target: 0xFFFFFFFF,
               flag: 1}


def _classes(builder):
    out: dict = {}
    for t in set(builder._parent) | set(builder._parent.values()):
        out.setdefault(builder._find(t), []).append(repr(t))
    return sorted(sorted(c) for c in out.values())


def test_u32_gadgets_equal_jax_graph_and_values():
    from plonky2_tpu_torch.prove.prover import witness_matrix
    jb, _ = _gadgets_circuit(jir.CircuitBuilder, jir.CircuitConfig)
    b, inputs = _gadgets_circuit(CircuitBuilder, CircuitConfig)
    assert [(g.key(), c) for g, c in b.gate_instances] == \
        [(g.key(), c) for g, c in jb.gate_instances]
    assert b.public_inputs == jb.public_inputs
    assert _classes(b) == _classes(jb)
    data = b.build(device="cpu")
    _, store = witness_matrix(data.prover, inputs)
    x, y, z = 0xFFFFFFFE, 0x89ABCDEF, 0xFFFFFFFF
    m = 0xFFFFFFFF

    def rot(v, n):
        return ((v << n) | (v >> (32 - n))) & m
    want = [(x * y + z) & m, (x * y + z) >> 32, (x + y) & m, (x + y) >> 32,
            (x - y - 1) & m, int(x - y - 1 < 0), (2 * x + 2 * y + z) & m,
            (15 * x) >> 32, m - x, (x << 5) & m, x >> 7, rot(x, 9), rot(y, 29),
            x & y, x ^ y, x ^ y ^ z ^ x, x ^ y ^ z ^ y ^ z, x,
            ((y << 8) | (x >> 24)) & m, ((x << 8) | (y >> 24)) & m,
            x ^ z, y ^ x, x & z, y & x, m - y, m - z, x, y, 0xDEADBEEF,
            int(x < y), int(x <= y)]
    assert [store.get(t) for t in b.public_inputs] == want


@pytest.fixture(scope="module")
def small_u32():
    return build_u32_mix(7, CircuitConfig.test_config())


def _load_vector_script():
    path = os.path.join(os.path.dirname(HERE), "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def test_u32_circuit_graph_equals_jax(small_u32):
    b, inputs, meta = small_u32
    jb, jinputs = _load_vector_script().small_u32(jir)
    assert meta["name"] == "u32_mix"
    assert [(g.key(), c) for g, c in b.gate_instances] == \
        [(g.key(), c) for g, c in jb.gate_instances]
    assert b.public_inputs == jb.public_inputs
    assert inputs == jinputs
    assert _classes(b) == _classes(jb)


@pytest.fixture(scope="module")
def small_u32_proof(small_u32):
    b, inputs, _ = small_u32
    num_gates = b.num_gates()
    data = b.build(device="cpu")
    return num_gates, data, data.prove(inputs)


def _fixture():
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)["small_u32"]


def test_small_u32_proof_matches_fixture(small_u32_proof):
    want = _fixture()
    num_gates, data, proof = small_u32_proof
    assert num_gates == want["num_gates"]
    assert data.common.degree_bits == want["degree_bits"] == 7
    assert [g.key() for g in data.common.gates] == [
        "U32RangeCheck(num_ops=7)", "Constant(num_consts=2)", "U32Arithmetic(num_ops=3)",
        "U32Interleave(num_ops=3)", "Arithmetic(num_ops=20)",
        "UninterleaveToU32(num_ops=2)", "U32Subtraction(num_ops=6)", "PublicInput",
        "Noop"]
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert len(raw) == want["proof_len"]
    assert hashlib.sha256(raw).hexdigest() == want["proof_sha256"]
    vk = serialize_verifier_data(data.verifier)
    assert hashlib.sha256(vk).hexdigest() == want["verifier_data_sha256"]


def test_port_verifies_small_u32_and_rejects_tampering(small_u32_proof):
    _, data, proof = small_u32_proof
    data.verify(proof)
    bad = copy.deepcopy(proof)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % gl.P
    with pytest.raises(ValueError, match="invalid proof"):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    c0, c1 = bad.openings.wires[3]
    bad.openings.wires[3] = (c0, (c1 + 1) % gl.P)
    with pytest.raises(ValueError, match="invalid proof"):
        data.verify(bad)
