"""The port's verifier and serde (`plonky2_tpu_torch.prove.verifier`,
`fri.fri_verify`, `gates.base.ExtAlg`, `serialization`) against the JAX
package.

Exact equality (tolerance 0): integer field arithmetic and byte formats.

* every ported gate's generic `eval` under `ExtAlg` gives the JAX gate's
  values on random GF(p^2) wires from a numpy seed;
* the port verifies its own proofs of the golden tiny circuit, the
  `small_chain` Poseidon chain and the `small_smt` SMT circuit, and rejects
  the tiny proof with a public input changed or an opening changed (the
  tampering of tests/test_prover.py);
* `deserialize_proof` reads the tiny circuit's proof bytes (the JAX
  package's, by the golden sha256) into the values the JAX reader gives,
  and reserializing gives the same bytes;
* `serialize_verifier_data` gives each fixture's `verifier_data_sha256`
  (the digest of the JAX build's key), the JAX package reads the port's
  bytes and writes them back unchanged, the port's reader round-trips them,
  and a gate or hasher the port does not carry raises NotImplementedError;
* no module of the port, and not chip_smoke.py, imports JAX or the JAX
  package.
"""
import ast
import copy
import hashlib
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

from plonky2_tpu import gates as jgates
from plonky2_tpu.gates import base as jbase
from plonky2_tpu.gates import comparison as jcmp
from plonky2_tpu.gates import u32_arithmetic as jarith
from plonky2_tpu.gates import u32_interleave as jil
from plonky2_tpu.gates.base_sum import BaseSumGate as JBaseSumGate
from plonky2_tpu.gates.random_access import RandomAccessGate as JRandomAccessGate
from plonky2_tpu_torch import gates, ir
from plonky2_tpu_torch.bench import build_poseidon_chain, build_smt_process
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.ir import CircuitConfig
from plonky2_tpu_torch.serialization import (Buffer, deserialize_proof,
                                             deserialize_verifier_data,
                                             gate_from_key, serialize_proof,
                                             serialize_verifier_data)

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


def _load(name):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


# Every gate the port carries, beside its JAX twin.
GATES = {
    "Arithmetic": (gates.ArithmeticGate(20), jgates.ArithmeticGate(20)),
    "Constant": (gates.ConstantGate(2), jgates.ConstantGate(2)),
    "PublicInput": (gates.PublicInputGate(), jgates.PublicInputGate()),
    "Noop": (gates.NoopGate(), jgates.NoopGate()),
    "Poseidon": (gates.PoseidonGate(), jgates.PoseidonGate()),
    "BaseSum": (gates.BaseSumGate(4, 8), JBaseSumGate(4, 8)),
    "U32Arithmetic": (gates.U32ArithmeticGate(3), jarith.U32ArithmeticGate(3)),
    "U32AddMany": (gates.U32AddManyGate(13, 3), jarith.U32AddManyGate(13, 3)),
    "U32RangeCheck": (gates.U32RangeCheckGate(7), jarith.U32RangeCheckGate(7)),
    "U32Subtraction": (gates.U32SubtractionGate(6), jcmp.U32SubtractionGate(6)),
    "Comparison": (gates.ComparisonGate(32), jcmp.ComparisonGate(32)),
    "U32Interleave": (gates.U32InterleaveGate(3), jil.U32InterleaveGate(3)),
    "UninterleaveToU32": (gates.UninterleaveToU32Gate(2), jil.UninterleaveToU32Gate(2)),
    "UninterleaveToB32": (gates.UninterleaveToB32Gate(2), jil.UninterleaveToB32Gate(2)),
    "RandomAccess": (gates.RandomAccessGate(4, 4), JRandomAccessGate(4, 4)),
}


def _rand_ext(rng, n):
    v = rng.randint(0, 2**32, size=(n, 2, 2), dtype=np.int64).astype(object)
    v = (v[:, :, 0] * 2**32 + v[:, :, 1]) % gl.P
    return [(int(a), int(b)) for a, b in v]


@pytest.mark.parametrize("name", list(GATES))
def test_ext_alg_eval_equals_jax(name):
    gate, jgate = GATES[name]
    assert gate.key() == jgate.key()
    rng = np.random.RandomState(0xE47 + len(name))
    wires = _rand_ext(rng, gate.num_wires)
    consts = _rand_ext(rng, max(gate.num_constants, 2))
    pi = _rand_ext(rng, 4)
    got = gate.eval(gates.EvalVars(wires, consts, pi), gates.ExtAlg())
    want = jgate.eval(jbase.EvalVars(wires, consts, pi), jbase.ExtAlg())
    assert len(got) == gate.num_constraints
    assert [tuple(c) for c in got] == [tuple(c) for c in want]


def _tiny():
    """The circuit of tests/test_golden_vectors.py, as the fixture script
    builds it (with the port's builder here)."""
    path = os.path.join(ROOT, "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.tiny(ir)


CIRCUITS = {
    "tiny": _tiny,
    "small_chain": lambda: build_poseidon_chain(6, CircuitConfig.test_config())[:2],
    "small_smt": lambda: build_smt_process(7, 4, CircuitConfig.test_config())[:2],
}
_proved: dict = {}


def _proof_of(name):
    """(data, proof) of one circuit, proved once for this module."""
    if name not in _proved:
        b, inputs = CIRCUITS[name]()
        data = b.build(device="cpu")
        _proved[name] = (data, data.prove(inputs))
    return _proved[name]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_port_verifies_its_proofs(name):
    data, proof = _proof_of(name)
    data.verify(proof)
    vk = serialize_verifier_data(data.verifier)
    assert hashlib.sha256(vk).hexdigest() == \
        _load("torch_port_vectors.json")[name]["verifier_data_sha256"]


def test_tampered_proofs_are_rejected():
    data, proof = _proof_of("tiny")
    bad = copy.deepcopy(proof)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % gl.P
    with pytest.raises(ValueError, match="invalid proof"):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    c0, c1 = bad.openings.wires[0]
    bad.openings.wires[0] = ((c0 + 1) % gl.P, c1)
    with pytest.raises(ValueError, match="invalid proof"):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    bad.fri.pow_witness ^= 1 << 40
    with pytest.raises(ValueError, match="invalid proof"):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    leaf = bad.fri.query_rounds[3].initial[1].leaf_values
    leaf[7] = (leaf[7] + 1) % gl.P
    with pytest.raises(ValueError, match="initial Merkle proof"):
        data.verify(bad)


def _fields(p):
    o = p.openings
    return (p.wires_cap, p.zs_pp_cap, p.quotient_cap,
            [[tuple(e) for e in g] for g in (o.constants_sigmas, o.wires,
                                             o.zs_partial_products, o.zs_next,
                                             o.quotient)],
            p.fri.commit_caps, p.fri.final_poly, p.fri.pow_witness,
            [([(i.leaf_values, i.siblings) for i in q.initial],
              [([tuple(e) for e in s.evals], s.siblings) for s in q.steps])
             for q in p.fri.query_rounds],
            p.public_inputs)


def test_deserialize_reads_jax_tiny_proof_bytes():
    from plonky2_tpu.serialization import deserialize_proof as jdeserialize_proof
    golden = _load("golden_vectors.json")
    _, proof = _proof_of("tiny")
    raw = serialize_proof(proof)
    assert hashlib.sha256(raw).hexdigest() == golden["tiny_circuit_proof_sha256"]
    back = deserialize_proof(raw)
    assert serialize_proof(back) == raw
    assert _fields(back) == _fields(jdeserialize_proof(raw))
    assert back.public_inputs == golden["tiny_circuit_public_inputs"]
    with pytest.raises(ValueError, match="trailing bytes"):
        deserialize_proof(raw + b"\0")
    with pytest.raises(EOFError):
        deserialize_proof(raw[:-1])


def test_verifier_data_bytes_equal_jax_and_roundtrip():
    # The fixture's digest is of the JAX build's key; the JAX package reads
    # the port's bytes and writes them back unchanged.
    from plonky2_tpu.serialization import deserialize_verifier_data as jread_vd
    from plonky2_tpu.serialization import serialize_verifier_data as jwrite_vd
    data, proof = _proof_of("tiny")
    vk = serialize_verifier_data(data.verifier)
    assert hashlib.sha256(vk).hexdigest() == \
        _load("torch_port_vectors.json")["tiny"]["verifier_data_sha256"]
    jvd = jread_vd(vk)
    assert jwrite_vd(jvd) == vk
    assert [g.key() for g in jvd.common.gates] == [g.key() for g in data.common.gates]
    assert jvd.common.selector_info.groups == data.common.selector_info.groups
    vd = deserialize_verifier_data(vk)
    assert serialize_verifier_data(vd) == vk
    assert vd.common.k_is == data.common.k_is
    assert vd.common.num_partial_products == data.common.num_partial_products
    # the key read back verifies the proof
    from plonky2_tpu_torch.prove import verify
    verify(vd, proof)


@pytest.mark.parametrize("key", ["Exponentiation(num_power_bits=8)",
                                 "Poseidon2(width=12)", "LookupTable(num_slots=3)",
                                 "CosetInterpolation(subgroup_bits=4)",
                                 "ArithmeticExtension(num_ops=10)"])
def test_unported_gate_keys_raise_not_implemented(key):
    with pytest.raises(NotImplementedError, match=key.split("(")[0]):
        gate_from_key(key)


def test_gate_registry_and_unported_hasher():
    for gate, _ in GATES.values():
        assert gate_from_key(gate.key()).key() == gate.key()
    with pytest.raises(ValueError, match="unknown gate"):
        gate_from_key("Frobnicate(num_ops=2)")
    data, _ = _proof_of("tiny")
    vk = serialize_verifier_data(data.verifier)
    poseidon = b"\x08\x00\x00\x00poseidon"
    keccak = b"\x06\x00\x00\x00keccak"
    with pytest.raises(NotImplementedError, match="keccak"):
        deserialize_verifier_data(vk.replace(poseidon + poseidon, poseidon + keccak, 1))
    buf = Buffer()
    buf.write_str("u32 π")
    assert Buffer(buf.bytes()).read_str() == "u32 π"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "plonky2_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    bad = [(os.path.relpath(p, ROOT), m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "plonky2_tpu")]
    assert bad == []


def test_interpolate_coset_equals_jax():
    from plonky2_tpu.fri.fri import _interpolate_coset_s as jinterp
    from plonky2_tpu_torch.fri.fri import _interpolate_coset_s
    rng = random.Random(0xF21)
    pts = [rng.randrange(gl.P) for _ in range(16)]
    vals = [(rng.randrange(gl.P), rng.randrange(gl.P)) for _ in range(16)]
    beta = (rng.randrange(gl.P), rng.randrange(gl.P))
    assert _interpolate_coset_s(pts, vals, beta) == jinterp(pts, vals, beta)
