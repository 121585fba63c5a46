"""The port's circuit cache (`plonky2_tpu_torch.serialization.prover_serde`)
against the JAX package's bytes.

Exact equality (tolerance 0): a byte format and integer field arithmetic.

* `serialize_prover_data` of each small circuit (the golden tiny circuit,
  `small_chain`, `small_smt`, `small_u32`, `small_ecc`) has the fixture's
  `prover_data_sha256`, the digest of the JAX package's bytes for the same
  circuit (scripts/make_torch_port_vectors.py);
* `deserialize_prover_data(blob, device="cpu")` serializes back to the
  same bytes, and its recomputed constants/sigmas commit has the fixture's
  `cs_cap`;
* the tiny circuit loaded from bytes proves to the fixture's
  `proof_sha256`;
* a gadget hint that is not a NamedGenerator makes `serialize_prover_data`
  raise, as in the JAX package.
"""
import hashlib
import importlib.util
import json
import os

import pytest
import torch

from plonky2_tpu_torch import ir
from plonky2_tpu_torch.bench import (build_poseidon_chain, build_small_ecc,
                                     build_smt_process, build_u32_mix)
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.serialization import (deserialize_prover_data, serialize_proof,
                                             serialize_prover_data)
from plonky2_tpu_torch.witness import LambdaGenerator

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The builds' commits and the prove here are many small ops: one thread
    # avoids contention with the other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    path = os.path.join(ROOT, "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.tiny(ir)


CIRCUITS = {
    "tiny": _tiny,
    "small_chain": lambda: build_poseidon_chain(6, CircuitConfig.test_config())[:2],
    "small_smt": lambda: build_smt_process(7, 4, CircuitConfig.test_config())[:2],
    "small_u32": lambda: build_u32_mix(7, CircuitConfig.test_config())[:2],
    "small_ecc": lambda: build_small_ecc()[:2],
}


def _fixture(name):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[name]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_prover_data_bytes_equal_jax_and_roundtrip(name):
    want = _fixture(name)
    b, _ = CIRCUITS[name]()
    blob = serialize_prover_data(b.build(device="cpu").prover)
    assert hashlib.sha256(blob).hexdigest() == want["prover_data_sha256"]
    loaded = deserialize_prover_data(blob, device="cpu")
    assert loaded.verifier.cs_cap == want["cs_cap"]
    assert serialize_prover_data(loaded.prover) == blob


def test_tiny_circuit_loaded_from_bytes_proves_to_fixture():
    b, inputs = _tiny()
    loaded = deserialize_prover_data(serialize_prover_data(b.build(device="cpu").prover),
                                     device="cpu")
    proof = loaded.prove(inputs)
    assert hashlib.sha256(serialize_proof(proof)).hexdigest() == \
        _fixture("tiny")["proof_sha256"]


def test_non_named_hint_raises():
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.add_simple_generator(LambdaGenerator([x], lambda v: [(y, v[0] + 1)], outs=[y]))
    b.register_public_input(y)
    data = b.build(device="cpu")
    with pytest.raises(TypeError, match="non-serializable hint generators"):
        serialize_prover_data(data.prover)
