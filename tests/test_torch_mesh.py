"""The port's device mesh (`plonky2_tpu_torch.parallel`) against the JAX
package's, on CPU shards.

The port's mesh is single-controller, as JAX's is: one process, a list of
d devices (here d shards of the CPU device, the counterpart of the JAX
tests' 8 virtual CPU devices), explicit copies between the poly-sharded
and row-sharded layouts.  All checks are exact (tolerance 0):

* `Mesh` and `make_prover_mesh` raise for a size that is not a power of
  two, mixed device types, more CUDA devices than exist, and a mesh whose
  device type is not the circuit's;
* the sharded Merkle tree has `MerkleTree.build_cols`'s cap and openings at
  d = 1, 2, 4 and 8 (cap height 2: d = 8 hashes levels across shards);
* the cross-shard exclusive scans equal `_prefix_product` and `_prefix_sum`;
* `sharded_prove_step` gives the JAX function's cap and sample
  (`mesh_step_small` in tests/torch_port_vectors.json, recorded on the JAX
  8-device mesh) at d = 1, 2 and 8; a `slow` test calls the JAX function
  directly (its XLA compile takes about 35 s);
* `small_chain` proved on d = 1, 2, 8 and 16 shards (16 > 2^rate: zs(g*x)
  crosses shards), and `mixed_small` (lookups, u32, nonnative) on 8, give
  the fixture's proof bytes, which are the JAX package's, and the port's
  verifier accepts them.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from plonky2_tpu_torch.bench import build_mixed_small, build_poseidon_chain
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.hashes import poseidon
from plonky2_tpu_torch.ir import CircuitConfig
from plonky2_tpu_torch.merkle import MerkleTree, ShardedMerkleTree
from plonky2_tpu_torch.parallel import Mesh, make_prover_mesh, sharded_prove_step
from plonky2_tpu_torch.prove import prover
from plonky2_tpu_torch.serialization import serialize_proof

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU proves here are many small ops: one thread avoids contention
    # with the other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(name):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[name]


def _vector_script():
    path = os.path.join(os.path.dirname(HERE), "scripts", "make_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_vectors", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def _cpu_mesh(d):
    return Mesh((CPU,) * d)


def _rand(rng, shape):
    return gl.to_tensor(rng.randint(0, 1 << 62, size=shape).astype(np.uint64))


def _sha(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


@pytest.mark.parametrize("d", [0, 3, 6])
def test_mesh_size_must_be_a_power_of_two(d):
    with pytest.raises(ValueError, match="power of two"):
        Mesh((CPU,) * d)
    with pytest.raises(ValueError, match="power of two"):
        make_prover_mesh(d, "cpu")


def test_mesh_holds_one_device_type():
    with pytest.raises(ValueError, match="one type"):
        Mesh((CPU, torch.device("cuda", 0)))


def test_make_prover_mesh_counts_devices(monkeypatch):
    # the card's count as torch reports it; the JAX function would return
    # a smaller mesh where this one raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_prover_mesh(device="cuda").devices == (torch.device("cuda", 0),
                                                       torch.device("cuda", 1))
    assert make_prover_mesh(1, "cuda").size == 1
    with pytest.raises(ValueError, match="4 CUDA devices, 2 present"):
        make_prover_mesh(4, "cuda")
    assert make_prover_mesh(device="cpu").devices == (CPU,)
    assert make_prover_mesh(8, "cpu").devices == (CPU,) * 8


def test_placement_round_trips():
    rng = np.random.RandomState(5)
    mesh = _cpu_mesh(4)
    a = _rand(rng, (6, 16))
    shards = mesh.polys(a)                       # 2 rows a shard, 2 pad rows
    assert [s.shape[0] for s in shards] == [2, 2, 2, 2]
    assert torch.equal(mesh.gather(mesh.unpad(shards, 6), dim=0), a)
    assert torch.equal(mesh.gather(mesh.rows(a)), a)
    assert torch.equal(mesh.gather(mesh.polys_to_rows(mesh.unpad(shards, 6))), a)
    back = mesh.unpad(mesh.rows_to_polys(mesh.rows(a)), 6)
    assert torch.equal(mesh.gather(back, dim=0), a)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rows(a[:, :6])


@pytest.fixture(scope="module")
def small_chain():
    b, inputs, _ = build_poseidon_chain(6, CircuitConfig.test_config())
    return b.build(device="cpu"), inputs


def test_mesh_of_another_device_type_raises(small_chain):
    data, inputs = small_chain
    with pytest.raises(ValueError, match="cannot prove a circuit on cpu"):
        data.prove(inputs, mesh=Mesh((torch.device("cuda", 0),)))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_tree_equals_merkle_tree(d):
    # 13 columns: each shard is padded to the sponge rate as the whole is
    rng = np.random.RandomState(d)
    leaves = _rand(rng, (13, 64))
    want = MerkleTree.build_cols(leaves, 2, poseidon)
    mesh = _cpu_mesh(d)
    tree = ShardedMerkleTree.build_cols(mesh, mesh.rows(leaves), 2, poseidon)
    assert tree.cap_host() == want.cap_host()
    idx = [0, 37, 63, 32]
    for got, exp in zip(tree.open_many(idx), want.open_many(idx)):
        assert np.array_equal(got, exp)


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("op", ["product", "sum"])
def test_mesh_scans_equal_prefix_scans(op, d):
    rng = np.random.RandomState(9)
    r = _rand(rng, (3, 64))
    plain, gl_op, identity = {"product": (prover._prefix_product, gl.mul, 1),
                              "sum": (prover._prefix_sum, gl.add, 0)}[op]
    mesh = _cpu_mesh(d)
    got = prover._exclusive_scan_mesh(mesh, mesh.rows(r), gl_op, identity)
    assert torch.equal(mesh.gather(got), plain(r))


def _step_digests(cap, sample):
    cap = [[int(x) for x in row] for row in gl.from_tensor(cap)]
    return cap, _sha(np.ascontiguousarray(gl.from_tensor(sample), dtype="<u8").tobytes())


@pytest.mark.parametrize("d", [1, 2, 8])
def test_sharded_prove_step_equals_fixture(d):
    want = _fixture("mesh_step_small")
    wires = gl.to_tensor(_vector_script().mesh_step_wires(tuple(want["shape"])))
    cap, sample = sharded_prove_step(_cpu_mesh(d), wires, want["rate_bits"],
                                     want["cap_height"])
    assert sample.shape == (want["shape"][1] << want["rate_bits"],)
    assert _step_digests(cap, sample) == (want["cap"], want["sample_sha256"])


def test_sharded_prove_step_needs_divisible_shapes():
    wires = _rand(np.random.RandomState(2), (6, 32))
    with pytest.raises(ValueError, match="must divide"):
        sharded_prove_step(_cpu_mesh(4), wires, 3, 2)


@pytest.mark.slow
def test_sharded_prove_step_equals_jax():
    # ~35 s, nearly all XLA compiling the JAX step for the 8-device mesh
    import jax
    from plonky2_tpu.parallel import make_prover_mesh as jax_mesh
    from plonky2_tpu.parallel import sharded_prove_step as jax_step
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    wires = _vector_script().mesh_step_wires((8, 32))
    jcap, jsample = jax_step(jax_mesh(8), wires, 3, 2)
    cap, sample = sharded_prove_step(_cpu_mesh(8), gl.to_tensor(wires), 3, 2)
    assert np.array_equal(gl.from_tensor(cap), np.asarray(jcap))
    assert np.array_equal(gl.from_tensor(sample), np.asarray(jsample))


@pytest.mark.parametrize("d", [1, 2, 8, 16])
def test_small_chain_mesh_proof_equals_fixture(small_chain, d):
    data, inputs = small_chain
    want = _fixture("small_chain")
    proof = data.prove(inputs, mesh=_cpu_mesh(d))
    raw = serialize_proof(proof)
    assert (len(raw), _sha(raw)) == (want["proof_len"], want["proof_sha256"])
    data.verify(proof)


def test_mixed_small_mesh_proof_equals_fixture():
    want = _fixture("mixed_small")
    b, inputs, _ = build_mixed_small()
    data = b.build(device="cpu")
    proof = data.prove(inputs, mesh=make_prover_mesh(8, "cpu"))
    raw = serialize_proof(proof)
    assert (len(raw), _sha(raw)) == (want["proof_len"], want["proof_sha256"])
    data.verify(proof)
