"""The port's secp256k1 slice (`plonky2_tpu_torch.field.secp`,
`gates.random_access`, the biguint, nonnative and GLV hints,
`gadgets.biguint`, `gadgets.nonnative`, `gadgets.curve`, `gadgets.ecdsa`,
`bench.build_small_ecc` and `bench.build_ecdsa`) against the JAX package.

Exact equality (tolerance 0): integer arithmetic.

* the secp oracle: on 16 seeded scalars and points, add, double, neg, mul,
  batch_inverse, msm, glv_decompose, glv_mul, sign and verify return the
  JAX module's values;
* RandomAccessGate for bits 1..4 under test_config and standard_ecc_config:
  its copies, key and wire layout, its generators' wires, constraints that
  the generated rows satisfy and a bumped `claimed` wire does not, the
  generic `eval` under `BatchAlg` against JAX's on random rows, and the
  gate-key round trip;
* the eight biguint, nonnative and GLV hints on seeded inputs, zero divisors
  included;
* the biguint, nonnative, curve and GLV gadgets: the same gates, constants,
  copy classes and public inputs as the JAX builder, the same witness as
  the JAX scheduler, and public inputs equal to the secp oracle's values;
* `small_ecc` (2^9 rows under test_config): the fixture's graph digest,
  proof and verifier key (tests/torch_port_vectors.json), public inputs
  from the oracle, and the port's verifier accepts the proof and rejects
  it tampered;
* config 4 (`build_ecdsa(1)`, 2^16 rows): 55,421 gates and the fixture's
  graph digest, traced without a build.
"""
import copy
import hashlib
import json
import os
import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plonky2_tpu.gadgets  # noqa: F401  (attaches the JAX builder API)
import plonky2_tpu.gadgets.curve  # noqa: F401
import plonky2_tpu_torch.gadgets  # noqa: F401  (attaches the port's)
from plonky2_tpu import ir as jir
from plonky2_tpu.field import secp as jsecp
from plonky2_tpu.gadgets.biguint import set_biguint_target as jset_biguint
from plonky2_tpu.gates.base import BatchAlg as JBatchAlg
from plonky2_tpu.gates.base import EvalVars as JEvalVars
from plonky2_tpu.gates.random_access import RandomAccessGate as JRandomAccessGate
from plonky2_tpu.witness import generate_witness as jgenerate_witness
from plonky2_tpu.witness.hints import HINTS as JHINTS
from plonky2_tpu_torch.bench import build_ecdsa, build_small_ecc
from plonky2_tpu_torch.field import gl, secp
from plonky2_tpu_torch.gadgets.biguint import set_biguint_target
from plonky2_tpu_torch.gadgets.curve import BLIND
from plonky2_tpu_torch.gates import BatchAlg, EvalVars, RandomAccessGate
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.ir.digest import graph_digest
from plonky2_tpu_torch.serialization import (gate_from_key, serialize_proof,
                                             serialize_verifier_data)
from plonky2_tpu_torch.witness import generate_witness
from plonky2_tpu_torch.witness.hints import HINTS

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The CPU prove here is many small ops: one thread avoids contention
    # with the other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(key: str) -> dict:
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)[key]


def _limbs(v: int, n: int = 8) -> list:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


# ------------------------------------------------------------------
# the secp oracle
# ------------------------------------------------------------------

def _oracle_cases():
    rng = random.Random(0x5EC9)
    ks = [rng.randrange(1, secp.N) for _ in range(16)]
    pts = [secp.mul(secp.G, rng.randrange(1, secp.N)) for _ in range(16)]
    return rng, ks, pts


def _as_tuple(p):
    return (p.x, p.y, p.inf)


SECP_CASES = {
    "add": lambda m, rng, ks, pts: [_as_tuple(m.add(a, b)) for a, b in
                                    zip(pts, pts[1:] + pts[:1])]
    + [_as_tuple(m.add(pts[0], m.neg(pts[0]))), _as_tuple(m.add(pts[1], pts[1]))],
    "double": lambda m, rng, ks, pts: [_as_tuple(m.double(p)) for p in pts],
    "neg": lambda m, rng, ks, pts: [_as_tuple(m.neg(p)) for p in pts + [m.ZERO]],
    "mul": lambda m, rng, ks, pts: [_as_tuple(m.mul(p, k)) for p, k in zip(pts, ks)]
    + [_as_tuple(m.mul(pts[0], 0)), _as_tuple(m.mul(pts[0], m.N - 1))],
    "batch_inverse": lambda m, rng, ks, pts: m.batch_inverse([0] + ks + [0])
    + m.batch_inverse(ks, m.N),
    "msm": lambda m, rng, ks, pts: [_as_tuple(m.msm(pts[:i], ks[:i])) for i in (1, 2, 5, 16)]
    + [_as_tuple(m.summation(pts)), _as_tuple(m.summation(pts * 5))],
    "glv_decompose": lambda m, rng, ks, pts: [m.glv_decompose(k) for k in ks],
    "glv_mul": lambda m, rng, ks, pts: [_as_tuple(m.glv_mul(p, k)) for p, k in zip(pts, ks)],
    "sign_verify": lambda m, rng, ks, pts: [
        (sig, m.verify(h, sig, m.mul(m.G, sk)), m.verify(h + 1, sig, m.mul(m.G, sk)))
        for sk, h, nonce in zip(ks[:4], ks[4:8], ks[8:12])
        for sig in [m.sign(h, sk, nonce)]],
}


@pytest.mark.parametrize("name", list(SECP_CASES))
def test_secp_oracle_equals_jax(name):
    rng, ks, pts = _oracle_cases()
    jpts = [jsecp.Point(p.x, p.y) for p in pts]
    got = SECP_CASES[name](secp, rng, ks, pts)
    assert got == SECP_CASES[name](jsecp, rng, ks, jpts)
    if name == "glv_mul":
        assert got == [_as_tuple(secp.mul(p, k)) for p, k in zip(pts, ks)]
    if name == "sign_verify":
        assert all(ok and not bad for _, ok, bad in got)


# ------------------------------------------------------------------
# RandomAccessGate
# ------------------------------------------------------------------

CONFIGS = {"test": (CircuitConfig.test_config, jir.CircuitConfig.test_config),
           "ecc": (CircuitConfig.standard_ecc_config, jir.CircuitConfig.standard_ecc_config)}
ROWS = 5


def _ra_rows(gate, seed: int):
    """[num_wires, ROWS] uint64: each copy's index and items from the seed,
    the rest from the gate's generators."""
    rng = np.random.RandomState(seed)
    w = np.zeros((gate.num_wires, ROWS), dtype=np.uint64)
    for r in range(ROWS):
        vals = {}
        for c in range(gate.num_copies):
            ws = gate.wires_copy(c)
            vals[ws["index"]] = int(rng.randint(gate.vec_size))
            for i in range(gate.vec_size):
                vals[ws["items"] + i] = int(rng.randint(0, 2**62)) * 3 % gl.P
        for g in gate.generators(r, []):
            for wire, v in g.run(lambda t: vals[t[1]]):
                vals[wire[1]] = v
        for col, v in vals.items():
            w[col, r] = v
    return w


def _eval(gate, wires):
    return gl.from_tensor(torch.stack(gate.eval(EvalVars(list(gl.to_tensor(wires)), [], []),
                                                BatchAlg((wires.shape[1],), "cpu"))))


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_random_access_gate_equals_jax(bits, config):
    cfg, jcfg = CONFIGS[config]
    gate = RandomAccessGate.from_config(cfg(), bits)
    jgate = JRandomAccessGate.from_config(jcfg(), bits)
    assert (gate.key(), gate.num_copies, gate.num_wires, gate.degree,
            gate.num_constraints) == (jgate.key(), jgate.num_copies, jgate.num_wires,
                                      jgate.degree, jgate.num_constraints)
    assert gate.num_wires <= cfg().num_wires
    assert [gate.wires_copy(c) for c in range(gate.num_copies)] == \
        [jgate.wires_copy(c) for c in range(gate.num_copies)]
    assert gate_from_key(gate.key()).key() == gate.key()

    valid = _ra_rows(gate, 0x4A + bits)
    assert np.array_equal(valid, _ra_rows(jgate, 0x4A + bits))
    for g, jg in zip(gate.generators(3, []), jgate.generators(3, [])):
        assert [tuple(d) for d in g.deps] == [tuple(d) for d in jg.deps]
        assert [tuple(o) for o in g.outs] == [tuple(o) for o in jg.outs]
    assert not _eval(gate, valid).any()          # the generated rows satisfy
    bumped = valid.copy()
    claimed = gate.wires_copy(gate.num_copies - 1)["claimed"]
    bumped[claimed] = (bumped[claimed] + np.uint64(1)) % np.uint64(gl.P)
    cs = _eval(gate, bumped)
    assert cs[-1].all() and not cs[:-1].any()    # only that copy's fold fails

    rng = np.random.RandomState(0x4B + bits)
    rand = (rng.randint(0, 2**62, size=(gate.num_wires, 6), dtype=np.int64)
            .astype(np.uint64) * np.uint64(3)) % np.uint64(gl.P)
    rand[:, 0] = gl.P - 1
    wires = np.concatenate([valid, rand], axis=1)
    jcs = jgate.eval(JEvalVars([jnp.asarray(r) for r in wires], [], []),
                     JBatchAlg((wires.shape[1],)))
    assert np.array_equal(_eval(gate, wires), np.stack([np.asarray(c) for c in jcs]))


# ------------------------------------------------------------------
# hints
# ------------------------------------------------------------------

def _hint_cases():
    rng = random.Random(0x41E7)
    P, N = secp.P, secp.N

    def big(bits):
        return rng.randrange(1 << bits)

    def lim(v, n=8):
        return _limbs(v, n)

    a, b = big(256), big(100)
    return {
        "biguint_div_rem": [({"na": 8, "nb": 4}, lim(a) + lim(b, 4)),
                            ({"na": 8, "nb": 4}, lim(a) + lim(0, 4))],
        "nn_add": [({"p": P, "nl": 8, "n_out": 8}, lim(x) + lim(y))
                   for x, y in ((P - 1, P - 2), (big(255), 5), (0, 0))],
        "nn_add_many": [({"p": N, "nl": [8, 8, 8], "n_out": 8},
                         lim(N - 1) + lim(N - 2) + lim(big(256) % N))],
        "nn_sub": [({"p": P, "nl": 8, "n_out": 8}, lim(x) + lim(y))
                   for x, y in ((3, P - 1), (P - 1, 3), (7, 7))],
        "nn_mul": [({"p": P, "nl": 8, "n_out": 8, "n_ovf": 9}, lim(x) + lim(y))
                   for x, y in ((P - 1, P - 1), (big(256) % P, big(256) % P))],
        "nn_inv": [({"p": N, "n_inv": 8, "n_div": 9}, lim(x))
                   for x in (1, N - 1, big(256) % N, 0)],
        "nn_div": [({"p": P, "nl": 8, "n_out": 8}, lim(x) + lim(y))
                   for x, y in ((big(256) % P, big(256) % P), (5, 0))],
        "glv_decompose": [({"n1": 8, "n2": 8}, lim(k))
                          for k in (0, 1, N - 1, big(256) % N, big(256) % N)],
    }


@pytest.mark.parametrize("name", list(_hint_cases()))
def test_hint_equals_jax(name):
    for params, vals in _hint_cases()[name]:
        got = HINTS[name](params, vals)
        assert got == JHINTS[name](params, vals)
        assert all(0 <= v < gl.P for v in got)


# ------------------------------------------------------------------
# gadgets
# ------------------------------------------------------------------

def _biguint_circuit(b, set_big):
    a = b.add_virtual_biguint_target(8)
    c = b.add_virtual_biguint_target(3)
    d, r = b.div_rem_biguint(a, c)
    outs = [b.add_biguint(a, c), b.sub_biguint(a, c), b.mul_biguint(a, c), d, r,
            b.mul_biguint_by_const(c, secp.P - secp.N)]
    flags = [b.cmp_biguint(a, c), b.cmp_biguint(c, a), b.cmp_biguint(c, c)]
    b.register_public_inputs([t.target for o in outs for t in o.limbs] + flags)
    av, cv = (1 << 255) + 12345, (1 << 95) + 977
    inputs: dict = {}
    set_big(inputs, a, av)
    set_big(inputs, c, cv)
    want = [(av + cv, 9), (av - cv, 8), (av * cv, 11), (av // cv, 8), (av % cv, 3),
            (cv * (secp.P - secp.N), None)]
    return b, inputs, want, [0, 1, 1]


def _nonnative_circuit(b, set_big):
    P = secp.P
    x = b.add_virtual_nonnative_target(P)
    y = b.add_virtual_nonnative_target(P)
    outs = [b.add_nonnative(x, y), b.add_many_nonnative([x, y, x]),
            b.sub_nonnative(y, x), b.mul_nonnative(x, y), b.inv_nonnative(x),
            b.div_nonnative(y, x), b.div_hint_nonnative(y, x), b.neg_nonnative(x)]
    bits = b.split_nonnative_to_bits(x)
    nibbles = b.split_nonnative_to_4_bit_limbs(y)
    back = b.recombine_nonnative_4_bit_limbs(nibbles, P)
    b.connect_nonnative(back, y)
    b.register_public_inputs([t.target for o in outs for t in o.value.limbs]
                             + bits + nibbles)
    xv, yv = P - 5, (1 << 200) + 3
    inputs: dict = {}
    set_big(inputs, x.value, xv)
    set_big(inputs, y.value, yv)
    q = yv * pow(xv, P - 2, P) % P
    want = [((xv + yv) % P, 8), ((2 * xv + yv) % P, 8), ((yv - xv) % P, 8),
            (xv * yv % P, 8), (pow(xv, P - 2, P), 8), (q, 8), (q, 8), ((-xv) % P, 8)]
    extra = [(xv >> i) & 1 for i in range(256)] + [(yv >> (4 * i)) & 15 for i in range(64)]
    return b, inputs, want, extra


def _curve_circuit(b, set_big):
    p1 = b.add_virtual_affine_point_target()
    p2 = b.add_virtual_affine_point_target()
    cond = b.add_virtual_target()
    index = b.add_virtual_target()
    b.assert_bool(cond)
    b.curve_assert_valid(p1)
    pts = [b.curve_add(p1, p2), b.curve_double(p1), b.curve_neg(p2),
           b.curve_conditional_add(p1, p2, cond)]
    pts.append(b.random_access_curve_points(index, [p1, p2, pts[0]]))
    pts.extend(b.precompute_window(p2, 2, BLIND))
    b.register_public_inputs([t.target for pt in pts for c in (pt.x, pt.y)
                              for t in c.value.limbs])
    rng = random.Random(0xC0E)
    v1 = secp.mul(secp.G, rng.randrange(1, secp.N))
    v2 = secp.mul(secp.G, rng.randrange(1, secp.N))
    inputs: dict = {cond: 1, index: 2}
    for t, v in ((p1, v1), (p2, v2)):
        set_big(inputs, t.x.value, v.x)
        set_big(inputs, t.y.value, v.y)
    s = secp.add(v1, v2)
    window = [BLIND, secp.add(BLIND, v2), secp.add(secp.add(BLIND, v2), v2)]
    window.append(secp.add(window[-1], v2))
    want = [s, secp.double(v1), secp.neg(v2), s, s] + window
    return b, inputs, [(c, 8) for pt in want for c in (pt.x, pt.y)], []


def _glv_circuit(b, set_big):
    k = b.add_virtual_nonnative_target(secp.N)
    k1, k2, k1_neg, k2_neg = b.decompose_secp256k1_scalar(k)
    b.register_public_inputs([t.target for c in (k1, k2) for t in c.value.limbs]
                             + [k1_neg, k2_neg])
    kv = random.Random(0x6C7).randrange(secp.N)
    inputs: dict = {}
    set_big(inputs, k.value, kv)
    m1, n1, m2, n2 = secp.glv_decompose(kv)
    assert (m1 * (-1 if n1 else 1) + secp.GLV_LAMBDA * m2 * (-1 if n2 else 1)) % secp.N == kv
    return b, inputs, [(m1, 8), (m2, 8)], [int(n1), int(n2)]


GADGETS = {"biguint": _biguint_circuit, "nonnative": _nonnative_circuit,
           "curve": _curve_circuit, "glv": _glv_circuit}


def _classes(builder):
    out: dict = {}
    for t in set(builder._parent) | set(builder._parent.values()):
        out.setdefault(builder._find(t), []).append(repr(t))
    return sorted(sorted(c) for c in out.values())


def _witness(builder, inputs, generate):
    """The witness scheduler run over the builder's graph, without a build."""
    rep = {t: builder._find(t) for t in set(builder._parent) | set(builder._parent.values())}
    gens = list(builder.custom_generators)
    for r, (g, consts) in enumerate(builder.gate_instances):
        gens.extend(g.generators(r, consts))
    pd = SimpleNamespace(rep_of=lambda t: rep.get(t, t), generators=gens)
    return generate(pd, inputs)


def _biguint_values(want):
    return [x for v, n in want for x in _limbs(v, n)]


@pytest.mark.parametrize("name", list(GADGETS))
def test_gadgets_equal_jax_graph_and_witness(name):
    b, inputs, want, extra = GADGETS[name](CircuitBuilder(CircuitConfig.test_config()),
                                          lambda i, t, v: set_biguint_target(i, t, v))
    jb, jinputs, _, _ = GADGETS[name](jir.CircuitBuilder(jir.CircuitConfig.test_config()),
                                      jset_biguint)
    assert [(g.key(), c) for g, c in b.gate_instances] == \
        [(g.key(), c) for g, c in jb.gate_instances]
    assert b.public_inputs == jb.public_inputs
    assert inputs == jinputs
    assert _classes(b) == _classes(jb)
    store = _witness(b, inputs, generate_witness)
    jstore = _witness(jb, jinputs, jgenerate_witness)
    assert store._vals == jstore._vals
    pis = [store.get(t) for t in b.public_inputs]
    if name == "biguint":       # mul_biguint_by_const's width is its own
        n_last = len(pis) - len(extra) - sum(n for _, n in want[:-1])
        want = want[:-1] + [(want[-1][0], n_last)]
    assert pis == _biguint_values(want) + extra


# ------------------------------------------------------------------
# small_ecc: the slice proved on the CPU
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_ecc():
    return build_small_ecc()


def test_small_ecc_graph_equals_jax(small_ecc):
    b, inputs, meta = small_ecc
    want = _fixture("small_ecc")
    assert meta["name"] == "small_ecc"
    assert b.num_gates() == want["num_gates"] < (1 << 9) - 16
    assert graph_digest(b) == want["graph_sha256"]


@pytest.fixture(scope="module")
def small_ecc_proof(small_ecc):
    b, inputs, _ = small_ecc
    data = b.build(device="cpu")
    return data, data.prove(inputs)


def test_small_ecc_proof_matches_fixture(small_ecc, small_ecc_proof):
    want = _fixture("small_ecc")
    _, inputs, _ = small_ecc
    data, proof = small_ecc_proof
    assert data.common.degree_bits == want["degree_bits"] == 9
    assert [[int(x) for x in d] for d in data.verifier.cs_cap] == want["cs_cap"]
    raw = serialize_proof(proof)
    assert proof.public_inputs == want["public_inputs"]
    assert len(raw) == want["proof_len"]
    assert hashlib.sha256(raw).hexdigest() == want["proof_sha256"]
    vk = serialize_verifier_data(data.verifier)
    assert hashlib.sha256(vk).hexdigest() == want["verifier_data_sha256"]

    # the public inputs from the oracle: p1 + p2, 2 p1, the selected point,
    # then the GLV split of k
    rng = random.Random(0xECC5A11)
    v1 = secp.mul(secp.G, rng.randrange(1, secp.N))
    v2 = secp.mul(secp.G, rng.randrange(1, secp.N))
    index = rng.randrange(4)
    kv = rng.randrange(secp.N)
    s, d = secp.add(v1, v2), secp.double(v1)
    m1, n1, m2, n2 = secp.glv_decompose(kv)
    pts = [s, d, [v1, v2, s, d][index]]
    assert proof.public_inputs == [x for pt in pts for c in (pt.x, pt.y) for x in _limbs(c)] \
        + _limbs(m1) + _limbs(m2) + [int(n1), int(n2)]
    assert sorted(inputs.values()) == sorted(
        [index] + _limbs(v1.x) + _limbs(v1.y) + _limbs(v2.x) + _limbs(v2.y) + _limbs(kv))


def test_port_verifies_small_ecc_and_rejects_tampering(small_ecc_proof):
    data, proof = small_ecc_proof
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


# ------------------------------------------------------------------
# config 4 at full size, traced without a build
# ------------------------------------------------------------------

def test_config4_graph_equals_fixture():
    want = _fixture("config4")
    b, inputs, meta = build_ecdsa(1)
    num_gates = b.num_gates()
    assert num_gates == want["num_gates"] == 55421
    # build() adds the public-input gate, then pads to a power of two
    assert num_gates.bit_length() == want["degree_bits"] == 16
    assert meta == {"name": "ecdsa_verify", "batch": 1}
    assert graph_digest(b) == want["graph_sha256"]
    assert len(inputs) == 5 * 8
