"""The port's lookups (`plonky2_tpu_torch.gates.lookup`, the logUp phase
of `prove.prover`, its terms in `prove.verifier`, the `lookup_out` and
`lookup_mults` hints, `bench.build_mixed_small` and
`bench.build_lookup_bytes`) against the JAX package.

Exact equality (tolerance 0): integer field arithmetic and byte formats.

* both gates' generic `eval` under `BatchAlg` and `ExtAlg` gives the JAX
  gate's values on wires and constants made from a numpy seed;
* `lookup_info` of the compiled `small_lookup` circuit equals the JAX
  function's on the same gates and selectors;
* `lookup_phase` (plain torch: one batched inverse, one exclusive scan)
  equals the JAX kernel's on seeded inputs at n = 2^6, k = 6, nc = 2;
* `small_lookup` (tests/test_lookup.py's circuit under test_config): the
  proof, prover-data and verifier-key bytes of tests/torch_port_vectors.json,
  from the built circuit and from the circuit loaded from bytes, whose
  lookup masks equal the built one's and whose `lookup_out` hints share
  one params dict, as built;
* `mixed_small` and `lookup8` are held by their graph digests (no build);
* the port's versions of tests/test_lookup.py's rejections (an input not in
  the table, inflated multiplicities, a tampered output) and of
  tests/test_witness_tape.py::test_tape_lookup.
"""
import copy
import hashlib
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.gates import base as jbase
from plonky2_tpu.gates import lookup as jlookup
from plonky2_tpu.ir import CircuitConfig as JCircuitConfig
from plonky2_tpu.prove import prover as jprover
from plonky2_tpu.serialization.serde import gate_from_key as jgate_from_key
from plonky2_tpu_torch.bench import build_lookup_bytes, build_mixed_small
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.gates import BatchAlg, EvalVars, ExtAlg
from plonky2_tpu_torch.gates import lookup
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.ir.digest import graph_digest
from plonky2_tpu_torch.prove import prover
from plonky2_tpu_torch.prove.prover import scheduler_witness_matrix, witness_matrix
from plonky2_tpu_torch.serialization import (serialize_proof,
                                             serialize_verifier_data)
from plonky2_tpu_torch.serialization.prover_serde import (deserialize_prover_data,
                                                          serialize_prover_data)
from plonky2_tpu_torch.witness import hints

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


GEN = _vector_script()
XS = [3, 7, 7, 0, 15, 4, 4, 4]


def _fixture(name):
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[name]


def _sha(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def _lookup_circuit(xs):
    """tests/test_lookup.py `build_lookup_circuit` in the port."""
    from plonky2_tpu_torch import ir
    b, inputs = GEN.small_lookup(ir, xs)
    return b.build(device="cpu"), inputs


@pytest.fixture(scope="module")
def small_lookup():
    data, inputs = _lookup_circuit(XS)
    return data, inputs, data.prove(inputs)


# ---------------------------------------------------------------- gates

def _rand_field(rng, shape):
    hi = rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint64)
    lo = rng.randint(0, 2**32, size=shape, dtype=np.int64).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo) % np.uint64(gl.P)


GATES = {"Lookup": lookup.LookupGate(6), "LookupTable": lookup.LookupTableGate(6)}


@pytest.mark.parametrize("name", list(GATES))
@pytest.mark.parametrize("alg", ["batch", "ext"])
def test_gate_eval_equals_jax(name, alg):
    gate = GATES[name]
    jgate = jgate_from_key(gate.key())
    assert type(jgate).__name__ == type(gate).__name__
    for attr in ("num_wires", "num_constants", "degree", "num_constraints"):
        assert getattr(gate, attr) == getattr(jgate, attr), attr
    rng = np.random.RandomState(0x100C + len(name))
    nconst = max(gate.num_constants, 1)
    if alg == "batch":
        m = 16
        wires = _rand_field(rng, (gate.num_wires, m))
        consts = _rand_field(rng, (nconst, m))
        wires[2, :4] = gl.P - 1                 # m = -1 on the first rows
        got = gate.eval(EvalVars(list(gl.to_tensor(wires)), list(gl.to_tensor(consts)),
                                 []), BatchAlg((m,), "cpu"))
        want = jgate.eval(jbase.EvalVars([jnp.asarray(r) for r in wires],
                                         [jnp.asarray(r) for r in consts], []),
                          jbase.BatchAlg((m,)))
        assert len(got) == gate.num_constraints
        for g, w in zip(got, want):
            assert np.array_equal(gl.from_tensor(g), np.asarray(w))
    else:
        def ext_vals(n):
            v = _rand_field(rng, (n, 2))
            return [(int(a), int(b)) for a, b in v]
        wires, consts = ext_vals(gate.num_wires), ext_vals(nconst)
        got = gate.eval(EvalVars(wires, consts, []), ExtAlg())
        want = jgate.eval(jbase.EvalVars(wires, consts, []), jbase.ExtAlg())
        assert [tuple(c) for c in got] == [tuple(c) for c in want]


def test_lookup_info_equals_jax(small_lookup):
    data, _, _ = small_lookup
    common = data.common
    jcommon = types.SimpleNamespace(
        gates=[jgate_from_key(g.key()) for g in common.gates],
        selector_info=common.selector_info)
    got = lookup.lookup_info(common)
    assert got["has"] and got["k"] == lookup.LOOKUP_SLOTS
    assert got == jlookup.lookup_info(jcommon)
    # without the lookup gates: no lookup phase
    plain = types.SimpleNamespace(gates=[g for g in common.gates
                                         if "Lookup" not in g.key()],
                                  selector_info=common.selector_info)
    assert lookup.lookup_info(plain) == {"has": False, "k": 0}


def test_duplicate_table_inputs_raise():
    b = CircuitBuilder(CircuitConfig.test_config())
    with pytest.raises(ValueError, match="duplicate table inputs"):
        b.add_lookup_table([(1, 2), (3, 4), (1, 5)])


# ---------------------------------------------------------------- logUp phase

def test_lookup_phase_equals_jax():
    degree_bits, k = 6, 6
    n = 1 << degree_bits

    def common_of(cfg, gates):
        # the fields `_make_kernels` / `_Kernels` read; one selector group
        sel = types.SimpleNamespace(groups=[[0, 1]], gate_group=[0, 0], unused=2)
        return types.SimpleNamespace(config=cfg, degree_bits=degree_bits,
                                     num_partial_products=2, gates=gates,
                                     selector_info=sel)

    jcommon = common_of(JCircuitConfig.test_config(),
                        [jlookup.LookupGate(k), jlookup.LookupTableGate(k)])
    kernels = prover._Kernels(common_of(CircuitConfig.test_config(),
                                        [lookup.LookupGate(k),
                                         lookup.LookupTableGate(k)]), "cpu")
    nc, nr = kernels.nc, kernels.nr
    assert nc == 2
    rng = np.random.RandomState(0x10C0)
    routed = _rand_field(rng, (nr, n))
    routed[2:3 * k:3, :5] = gl.P - 1            # edge values in the m wires
    lk = rng.randint(0, 2, size=(k, n)).astype(np.uint64)
    tb = (1 - lk) * rng.randint(0, 2, size=(k, n)).astype(np.uint64)
    lams = [int(v) for v in _rand_field(rng, (nc,))]
    lgams = [int(v) for v in _rand_field(rng, (nc,))]
    got = kernels.lookup_phase(gl.to_tensor(routed), gl.to_tensor(lk),
                               gl.to_tensor(tb), lams, lgams)
    # the JAX kernel's body, run eagerly: compiling it costs ~15 s here
    with jax.disable_jit():
        want = jprover._make_kernels(jcommon)["lookup_phase"](
            jnp.asarray(routed), jnp.asarray(lk), jnp.asarray(tb),
            jnp.asarray(np.asarray(lams, dtype=np.uint64)),
            jnp.asarray(np.asarray(lgams, dtype=np.uint64)))
    got = gl.from_tensor(got)
    assert got.shape == (nc * (k + 1), n)
    assert np.array_equal(got, np.asarray(want))
    assert got[k, 0] == 0 and got[2 * k + 1, 0] == 0        # S[0] = 0


# ---------------------------------------------------------------- small_lookup

@pytest.mark.parametrize("source", ["built", "loaded"])
def test_small_lookup_bytes_equal_fixture(small_lookup, source):
    want = _fixture("small_lookup")
    data, inputs, proof = small_lookup
    blob = serialize_prover_data(data.prover)
    assert _sha(blob) == want["prover_data_sha256"]
    if source == "loaded":
        loaded = deserialize_prover_data(blob, device="cpu")
        assert loaded.verifier.cs_cap == want["cs_cap"]
        info = lookup.lookup_info(loaded.common)
        assert info == lookup.lookup_info(data.common)
        for a, b in zip(prover._lookup_masks(loaded.prover, info),
                        prover._lookup_masks(data.prover, info)):
            assert torch.equal(a, b)
        # the table's uses share one params dict again, as built
        outs = [g.params for g in loaded.prover.custom_generators
                if g.name == "lookup_out"]
        assert len(outs) == len(XS) and all(p is outs[0] for p in outs)
        data, proof = loaded, loaded.prove(inputs)
    assert data.verifier.cs_cap == want["cs_cap"]
    assert _sha(serialize_verifier_data(data.verifier)) == want["verifier_data_sha256"]
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert len(raw) == want["proof_len"] and _sha(raw) == want["proof_sha256"]
    data.verify(proof)


def test_small_lookup_graph_and_wire_matrix(small_lookup):
    from plonky2_tpu_torch import ir
    b, _ = GEN.small_lookup(ir)
    assert graph_digest(b) == _fixture("small_lookup")["graph_sha256"]
    data, inputs, _ = small_lookup
    wires, _ = witness_matrix(data.prover, inputs)
    assert GEN.wire_matrix_sha256(wires) == _fixture("small_lookup")["wire_matrix_sha256"]


@pytest.mark.parametrize("name", ["mixed_small", "lookup8"])
def test_lookup_circuit_graph_digest_equals_fixture(name):
    make = {"mixed_small": build_mixed_small, "lookup8": build_lookup_bytes}[name]
    b, inputs, _ = make()
    assert graph_digest(b) == _fixture(name)["graph_sha256"]
    if name == "lookup8":
        # 47,616 byte lookups into the S-box of seed 0x100C8
        uses = b._lookup_uses[0]
        assert len(uses) == 47616 and len(inputs) == 47616
        assert sorted(p[1] for p in b._lookup_tables[0]) == list(range(256))
        assert all(0 <= v < 256 for v in inputs.values())


# ---------------------------------------------------------------- rejections

def test_lookup_rejects_value_not_in_table():
    data, inputs = _lookup_circuit([3, 5])
    inputs[list(inputs)[0]] = 77                 # not a table input
    with pytest.raises(ValueError, match="not in table"):
        data.prove(inputs)


def test_lookup_rejects_wrong_multiplicities(small_lookup):
    """Inflated multiplicities: the logUp running sum no longer telescopes
    to zero, so the constraint identity at zeta fails."""
    data, inputs, _ = small_lookup
    good = hints.HINTS["lookup_mults"]

    def bad_mults(params, vals):
        out = good(params, vals)
        out[0] = (out[0] + 1) % gl.P             # inflate one count
        return out

    hints.HINTS["lookup_mults"] = bad_mults
    try:
        proof = data.prove(inputs)
    finally:
        hints.HINTS["lookup_mults"] = good
    with pytest.raises(ValueError, match="constraint identity"):
        data.verify(proof)


def test_lookup_rejects_tampered_output(small_lookup):
    data, _, proof = small_lookup
    bad = copy.deepcopy(proof)
    bad.public_inputs[-1] = (bad.public_inputs[-1] + 1) % gl.P
    with pytest.raises(ValueError):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    row = prover.get_kernels(data.prover).n_zb         # the first A_0
    e = bad.openings.zs_partial_products[row]
    bad.openings.zs_partial_products[row] = ((e[0] + 1) % gl.P, e[1])
    with pytest.raises(ValueError):
        data.verify(bad)


def test_tape_lookup():
    tab = [(i, (3 * i + 1) % 31) for i in range(8)]
    b = CircuitBuilder(CircuitConfig.test_config())
    tid = b.add_lookup_table(tab)
    x = b.add_virtual_target()
    y = b.lookup(x, tid)
    b.register_public_input(y)
    pd = b.build(device="cpu").prover
    wires, store = witness_matrix(pd, {x: 4})
    want, dyn_store = scheduler_witness_matrix(pd, {x: 4})
    assert np.array_equal(wires, want)
    assert store.get(y) == dyn_store.get(y) == 13
