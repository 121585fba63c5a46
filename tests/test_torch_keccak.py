"""The port's Keccak-256 gadget (`plonky2_tpu_torch.gadgets.keccak`), the
Keccak transcript hasher (`plonky2_tpu_torch.hashes.keccak_hash`) and the
transcript hasher choice of `CircuitConfig`, against the JAX package.

Exact equality (tolerance 0): integer field arithmetic.

* the round constants, rotation offsets and pi lane order equal the JAX
  module's and the reference's tables (keccak256.rs:50-77);
* keccak-f1600 on lanes, and `keccak_hash.permute_s` and `permute_cols` on
  width-12 states, equal the JAX functions (lanes at or above 2^63
  included); the column sponges equal the scalar ones;
* `keccak256_host` gives the Ethereum digests of the port's
  `ETH_SHORT_VECTORS + ETH_LONG_VECTORS`, as the JAX host function does;
* `small_keccak` (scripts/make_torch_port_vectors.py, the JAX package's
  fixture): the u64 xor / rotate / chi circuit of tests/test_keccak.py
  under test_config, and the 20-step two_to_one chain of
  tests/test_keccak_config.py under keccak_config (Keccak Merkle trees,
  transcript and grind), each proved on the CPU from the built and from
  the loaded circuit to the fixture's bytes; the loaded chain has the JAX
  build's constants/sigmas cap; a tampered opening is rejected;
* `keccak4`, the reference's 4-block circuit (2^15 rows), is held by its
  builder's graph digest, without a build (the card proves it:
  chip_smoke.py);
* the recursive verifier raises for an inner circuit under the Keccak or
  the Poseidon2 config, and for a Poseidon2 outer circuit.
"""
import copy
import hashlib
import importlib.util
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.gadgets import keccak as jkk
from plonky2_tpu.hashes import keccak_hash as jkh
from plonky2_tpu_torch import ir
from plonky2_tpu_torch.bench.circuits import (ETH_LONG_VECTORS, ETH_SHORT_VECTORS,
                                              build_keccak256)
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.gadgets import keccak as kk
from plonky2_tpu_torch.hashes import keccak_hash as kh, poseidon
from plonky2_tpu_torch.ir.digest import graph_digest
from plonky2_tpu_torch.recursion import add_proof_verification
from plonky2_tpu_torch.serialization import (deserialize_prover_data,
                                             deserialize_verifier_data, serialize_proof,
                                             serialize_prover_data, serialize_verifier_data)

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


# ------------------------------------------------------------------
# tables, permutations and sponges
# ------------------------------------------------------------------

def test_tables_equal_jax_and_reference():
    assert kk.RNDC == jkk.RNDC and kk.ROTC == jkk.ROTC and kk.PILN == jkk.PILN
    # the reference's hard-coded tables (keccak256.rs:50-77)
    assert kk.ROTC == [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41,
                       56, 8, 25, 43, 62, 18, 39, 61, 20, 44]
    assert kk.PILN == [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23,
                       19, 13, 12, 2, 20, 14, 22, 9, 6, 1]
    assert kk.RNDC[0] == 1 and kk.RNDC[23] == 0x8000000080008008
    assert kh.ROT == jkh._ROT
    # the column form's pi gather is the JAX round's rho + pi move
    for y in range(5):
        for x in range(5):
            assert kh.PI_SRC[y + 5 * ((2 * x + 3 * y) % 5)] == x + 5 * y


def test_f1600_equals_jax_host():
    rng = random.Random(0xF1)
    lanes = [[(1 << 64) - 1] * 25, [1 << 63] * 25] + \
        [[rng.randrange(1 << 64) for _ in range(25)] for _ in range(4)]
    got = gl.from_tensor(kh.f1600_cols(gl.to_tensor(lanes).T.contiguous())).T
    for row, lane in zip(got, lanes):
        assert [int(v) for v in row] == jkk.keccak_f1600_host(lane) \
            == kk.keccak_f1600_host(lane)


def test_permute_s_and_cols_equal_jax():
    states = _states(0x3C, 5)
    want = np.asarray(jax.jit(jkh.permute_cols)(jnp.asarray(
        np.asarray(states, dtype=np.uint64).T))).T
    got = gl.from_tensor(kh.permute_cols(gl.to_tensor(states).T.contiguous())).T
    assert np.array_equal(got, want)
    for s, row in zip(states, want):
        assert kh.permute_s(s) == jkh.permute_s(s) == [int(v) for v in row]


def test_column_sponges_equal_scalar():
    rng = random.Random(0x3D)
    # a batch wider than the CPU block, so the blocked path runs too
    B = kh.CPU_BLOCK + 3
    for L in (3, 8, 11, 17):
        cols = np.asarray([[rng.randrange(gl.P) for _ in range(B)] for _ in range(L)],
                          dtype=np.uint64)
        t = gl.to_tensor(cols)
        leaves = gl.from_tensor(kh.hash_or_noop_cols(t))
        for j in (0, 1, B - 1):
            col = [int(v) for v in cols[:, j]]
            assert [int(v) for v in leaves[:, j]] == kh.hash_or_noop_s(col) \
                == jkh.hash_or_noop_s(col)
    x, y = t[:4, :5], t[4:8, :5]
    pair = gl.from_tensor(kh.two_to_one_cols(x, y))
    for j in range(5):
        xs = [int(v) for v in gl.from_tensor(x)[:, j]]
        ys = [int(v) for v in gl.from_tensor(y)[:, j]]
        assert [int(v) for v in pair[:, j]] == kh.two_to_one_s(xs, ys) \
            == jkh.two_to_one_s(xs, ys)


def test_keccak256_host_ethereum_vectors():
    for hx, want in ETH_SHORT_VECTORS + ETH_LONG_VECTORS:
        data = bytes.fromhex(hx)
        assert kk.keccak256_host(data).hex() == want == jkk.keccak256_host(data).hex()


def test_config_hasher_modules():
    assert ir.CircuitConfig.keccak_config().transcript_module() is kh
    assert ir.CircuitConfig.keccak_config().hasher_module() is poseidon
    assert ir.CircuitConfig().transcript_module() is poseidon
    # a misspelt name raises here, not when a key written with it is read
    with pytest.raises(ValueError, match="keccak256"):
        ir.CircuitConfig(transcript_hasher="keccak256")
    with pytest.raises(ValueError, match="poseidon_2"):
        ir.CircuitConfig(algebraic_hasher="poseidon_2")


# ------------------------------------------------------------------
# circuits against the fixture
# ------------------------------------------------------------------

def _prove_built_and_loaded(b, inputs, want):
    """Build on the CPU, prove, check the fixture's digests, save and load
    the circuit and prove again: -> (data, proof, loaded)."""
    data = b.build(device="cpu")
    assert data.common.degree_bits == want["degree_bits"]
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    vk = serialize_verifier_data(data.verifier)
    assert hashlib.sha256(vk).hexdigest() == want["verifier_data_sha256"]
    assert serialize_verifier_data(deserialize_verifier_data(vk)) == vk
    proof = data.prove(inputs)
    data.verify(proof)
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert (len(raw), hashlib.sha256(raw).hexdigest()) == \
        (want["proof_len"], want["proof_sha256"])
    blob = serialize_prover_data(data.prover)
    assert hashlib.sha256(blob).hexdigest() == want["prover_data_sha256"]
    loaded = deserialize_prover_data(blob, "cpu")
    assert [[int(x) for x in d] for d in loaded.verifier.cs_cap] == want["cs_cap"]
    assert serialize_proof(loaded.prove(inputs)) == raw
    return data, proof, loaded


def test_round_circuit_proof_equals_jax():
    """Port of tests/test_keccak.py::test_one_theta_chi_round_circuit."""
    b, inputs = _vector_script().keccak_round(ir)
    _, proof, _ = _prove_built_and_loaded(b, inputs, _fixture("small_keccak")["round"])
    limbs = list(inputs.values())          # each lane's low then high u32
    vals = [limbs[2 * i] | limbs[2 * i + 1] << 32 for i in range(5)]
    x = vals[0] ^ vals[1] ^ vals[2] ^ vals[3] ^ vals[4]
    r = ((x << 1) | (x >> 63)) & kk.M64
    c = vals[0] ^ (~vals[1] & vals[2] & kk.M64)
    assert proof.public_inputs == [w for v in (x, r, c) for w in (v & 0xFFFFFFFF, v >> 32)]


def test_keccak_config_chain_proof_equals_jax():
    """Port of tests/test_keccak_config.py::test_prove_verify_under_keccak_transcript:
    the proof from the built and from the loaded circuit equals the JAX
    build's, and a tampered opening is rejected."""
    b, inputs = _vector_script().keccak_chain(ir)
    data, proof, loaded = _prove_built_and_loaded(b, inputs, _fixture("small_keccak")["chain"])
    assert data.common.config.transcript_hasher == "keccak"
    assert deserialize_verifier_data(serialize_verifier_data(data.verifier)) \
        .common.config.transcript_hasher == "keccak"
    bad = copy.deepcopy(proof)
    w0 = bad.openings.wires[0]
    bad.openings.wires[0] = ((w0[0] + 1) % gl.P, w0[1])
    with pytest.raises(ValueError):
        loaded.verify(bad)


def test_keccak4_graph_equals_jax():
    """The 4-block circuit's graph (24,883 gates, 2^15 rows) against the
    JAX builder's, without a build."""
    want = _fixture("keccak4")
    b, witnesses, meta = build_keccak256(4)
    assert b.num_gates() == want["num_gates"]
    assert graph_digest(b) == want["graph_sha256"]
    assert len(witnesses) == len(meta["digests"]) == len(want["proof_sha256"])


@pytest.mark.parametrize("inner, outer", [
    ("keccak", "poseidon"), ("poseidon2", "poseidon"), ("poseidon", "poseidon2")])
def test_recursion_needs_poseidon(inner, outer):
    """As in the JAX package, the recursive verifier replays the transcript
    with the Poseidon sponge: other hashers raise."""
    def config(name):
        return {"keccak": ir.CircuitConfig.keccak_config(),
                "poseidon2": ir.CircuitConfig.poseidon2_config(),
                "poseidon": ir.CircuitConfig()}[name]

    b = ir.CircuitBuilder(config(inner))
    x = b.add_virtual_target()
    b.register_public_input(b.mul(x, x))
    vd = b.build(device="cpu").verifier
    with pytest.raises(ValueError, match="Poseidon"):
        add_proof_verification(ir.CircuitBuilder(config(outer)), vd)
