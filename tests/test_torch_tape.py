"""The port's witness tape (`plonky2_tpu_torch.witness.tape`, the native
library `plonky2_tpu_torch/native/`) against the dynamic scheduler and the
JAX package.

Exact equality (tolerance 0): integer field arithmetic.

* for each small circuit (the golden tiny circuit, `small_chain`,
  `small_smt`, `small_u32` with its xor/sub/compare gates and `small_ecc`
  with its nonnative, GLV and random-access hints) the prover's wire
  matrix (`witness_matrix`: tape, scatter, batched aux fill) equals the
  dynamic scheduler's (`generate_witness`, a scatter loop and the same aux
  fill), every value the scheduler assigns reads the same from the tape's
  store, and the matrix has the fixture's `wire_matrix_sha256` (the JAX
  package's tape path, scripts/make_torch_port_vectors.py);
* the native Poseidon row engine gives the JAX package's scalar row
  (`_permute_row`) on random inputs from a numpy seed;
* a conflicting input raises ValueError and a generator cycle raises the
  scheduler's stall RuntimeError, as in the JAX package.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from plonky2_tpu.gates.poseidon_gate import _permute_row as jpermute_row
from plonky2_tpu_torch import ir, native
from plonky2_tpu_torch.bench import (build_poseidon_chain, build_small_ecc,
                                     build_smt_process, build_u32_mix)
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.hashes import poseidon
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.prove.prover import scheduler_witness_matrix, witness_matrix
from plonky2_tpu_torch.witness import LambdaGenerator, generate_witness
from plonky2_tpu_torch.witness.tape import generate_witness_tape

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The builds' commits here are many small ops: one thread avoids
    # contention with the other test workers.
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
CIRCUITS = {
    "tiny": lambda: GEN.tiny(ir),
    "small_chain": lambda: build_poseidon_chain(6, CircuitConfig.test_config())[:2],
    "small_smt": lambda: build_smt_process(7, 4, CircuitConfig.test_config())[:2],
    "small_u32": lambda: build_u32_mix(7, CircuitConfig.test_config())[:2],
    "small_ecc": lambda: build_small_ecc()[:2],
}


def _fixture(name):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[name]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_tape_wire_matrix_equals_scheduler_and_jax(name):
    b, inputs = CIRCUITS[name]()
    pd = b.build(device="cpu").prover
    wires, store = witness_matrix(pd, inputs)
    want, dyn_store = scheduler_witness_matrix(pd, inputs)
    for rep, v in dyn_store._vals.items():
        assert store.get_or_zero(rep) == v, rep
    assert wires.dtype == np.uint64 and np.array_equal(wires, want)
    assert GEN.wire_matrix_sha256(wires) == _fixture(name)["wire_matrix_sha256"]
    assert [store.get(t) for t in pd.pi_targets] == \
        [dyn_store.get(t) for t in pd.pi_targets]


def test_native_poseidon_rows_equal_jax_scalar_row():
    rng = np.random.RandomState(0x9051)
    rows = 6
    ins = rng.randint(0, 2**32, (rows, 12), dtype=np.int64).astype(np.uint64) << np.uint64(32)
    ins = (ins | rng.randint(0, 2**32, (rows, 12), dtype=np.int64).astype(np.uint64)) \
        % np.uint64(gl.P)
    ins[0, :4] = gl.P - 1                       # edge values
    swaps = np.asarray([0, 1, 0, 1, 1, 0], dtype=np.uint64)
    got = native.poseidon_rows(ins, swaps, poseidon.ROUND_CONSTANTS, poseidon.MDS,
                               poseidon.FULL_ROUNDS // 2, poseidon.PARTIAL_ROUNDS)
    for i in range(rows):
        aux, outs = jpermute_row([int(x) for x in ins[i]], int(swaps[i]))
        assert [int(x) for x in got[i]] == list(aux) + list(outs)


def test_conflicting_input_raises_value_error():
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add(x, x)
    b.register_public_input(y)
    pd = b.build(device="cpu").prover
    with pytest.raises(ValueError, match="conflicting witness value"):
        generate_witness_tape(pd, {x: 3, y: 999})
    with pytest.raises(ValueError, match="conflicting witness value"):
        generate_witness(pd, {x: 3, y: 999})


def test_generator_cycle_raises_stall():
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    a = b.add_virtual_target()
    c = b.add_virtual_target()
    # a <- c + 1 and c <- a + 1: each waits on the other's only producer
    b.add_simple_generator(LambdaGenerator([c], lambda v: [(a, v[0] + 1)], outs=[a]))
    b.add_simple_generator(LambdaGenerator([a], lambda v: [(c, v[0] + 1)], outs=[c]))
    b.register_public_input(b.add(x, c))
    pd = b.build(device="cpu").prover
    with pytest.raises(RuntimeError, match="witness generation stalled") as tape_err:
        witness_matrix(pd, {x: 5})
    with pytest.raises(RuntimeError, match="witness generation stalled") as dyn_err:
        generate_witness(pd, {x: 5})
    # the same generators are blocked on both paths
    assert str(tape_err.value).split(";")[0] == str(dyn_err.value).split(";")[0]
