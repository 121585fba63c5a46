"""The batch-ECDSA perf driver (`plonky2_tpu_torch.bench.perf`) on the CPU,
on the golden tiny circuit in place of the ECDSA circuit: its proof is the
JAX fixture's `tiny` bytes (`tests/torch_port_vectors.json`) and verifies,
the verifier-key and proof round trips hold, and `main` prints the lines
of the JAX package's `scripts/perf.py`, in its order.  The ECDSA circuits
themselves (batch 2, 2^17 rows; batch 20, 2^20 rows) are held to their
fixture entries on the card by `chip_smoke.py`.  The builder's copy
classes, whose union-find a batch-20 build walks about 24 M times, have
the JAX builder's representatives, with every path compressed."""

from __future__ import annotations

import ast
import contextlib
import copy
import hashlib
import io
import json
import os
import random
import re

import pytest
import torch

from plonky2_tpu import ir as jir
from plonky2_tpu_torch.bench import perf
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.ir import CircuitBuilder, CircuitConfig
from plonky2_tpu_torch.ir.builder import Wire
from plonky2_tpu_torch.prove.verifier import verify
from plonky2_tpu_torch.serialization import deserialize_proof, serialize_proof

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _tiny():
    """The circuit of tests/test_golden_vectors.py."""
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    z = b.mul_add(x, y, x)
    for t in b.two_to_one([x, y, z, x], [y, z, x, y]):
        b.register_public_input(t)
    return b, {x: 111, y: 222}


def _script_lines() -> list:
    """A regex for each line that scripts/perf.py prints, in its order:
    the f-strings' literal parts, each field any text."""
    with open(os.path.join(ROOT, "scripts", "perf.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"):
            continue
        arg = node.args[0]
        parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
        out.append((node.lineno, "".join(
            re.escape(p.value) if isinstance(p, ast.Constant) else ".+?" for p in parts)))
    return [pattern for _, pattern in sorted(out)]


@pytest.fixture(scope="module")
def driven():
    """`perf.main(["1", "--cpu"])` with the tiny circuit in place of
    `build_ecdsa`: (its stdout lines, what `run` returned)."""
    results = []
    run = perf.run

    def recording_run(*args, **kwargs):
        results.append(run(*args, **kwargs))
        return results[-1]

    # many small ops: one thread is the fastest on the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(perf, "build_ecdsa", lambda batch: (*_tiny(), {"batch": batch}))
            mp.setattr(perf, "run", recording_run)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert perf.main(["1", "--cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    return buf.getvalue().splitlines(), results[0]


@pytest.fixture(scope="module")
def want():
    with open(os.path.join(HERE, "torch_port_vectors.json")) as f:
        return json.load(f)["tiny"]


def test_perf_lines_follow_jax_script(driven):
    lines, _ = driven
    patterns = _script_lines()
    assert len(patterns) == 8 and patterns[-1] == "PERF\\ DRIVER\\ OK"
    assert len(lines) == len(patterns), lines
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(pattern, line), (line, pattern)
    assert lines[0].startswith("batch=1 num_gates=3 ")
    assert lines[1].startswith("built: degree 2^2 ")


def test_perf_run_proof_equals_fixture(driven, want):
    _, res = driven
    cold, warm = res["proofs"]
    assert cold == warm
    assert (len(cold), hashlib.sha256(cold).hexdigest()) == (want["proof_len"],
                                                             want["proof_sha256"])
    assert (res["num_gates"], res["degree_bits"]) == (want["num_gates"], want["degree_bits"])
    assert hashlib.sha256(res["vd_bytes"]).hexdigest() == want["verifier_data_sha256"]
    assert res["proof"].public_inputs == want["public_inputs"]
    assert len(res["prove_s"]) == 2 and res["verify_s"] > 0
    # off the card: no kernel launched and no device memory read
    assert all(v == 0 for step in perf.STEPS for v in res["launches"][step].values())
    assert res["peak_bytes"] == {"build": None, "proves": None}
    assert set(res["trees"]) == set(perf.STEPS)
    assert res["trees"]["prove"].name.startswith("prove (2^2 rows")


def test_perf_round_trips_and_verify(driven, want):
    _, res = driven
    vd, proof = res["vd"], res["proof"]
    assert vd.cs_cap == want["cs_cap"]
    assert serialize_proof(deserialize_proof(res["proofs"][0])) == res["proofs"][0]
    assert serialize_proof(proof) == res["proofs"][1]
    verify(vd, proof)
    bad = copy.deepcopy(proof)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % gl.P
    with pytest.raises(ValueError):
        verify(vd, bad)


@pytest.mark.parametrize("seed", [0x0F1, 0x0F2, 0x0F3])
def test_union_find_roots_equal_jax(seed):
    """The same seeded `connect` calls (virtual targets and routed wires,
    with the long chains that `connect(old, new)` builds) give every item
    the JAX builder's representative; after `_find`, every node on the
    path points at its root."""
    rng = random.Random(seed)
    port = CircuitBuilder(CircuitConfig.test_config())
    jax_b = jir.CircuitBuilder(jir.CircuitConfig.test_config())
    routed = CircuitConfig.test_config().num_routed_wires
    items = list(range(300)) + [Wire(r, c) for r in range(20) for c in range(routed)]
    chain = rng.sample(items, 120)
    pairs = list(zip(chain, chain[1:]))              # connect(old, new): a chain
    pairs += [tuple(rng.sample(items, 2)) for _ in range(400)]
    for a, b in pairs:
        port.connect(a, b)
        jax_b.connect(a, b)
    order = rng.sample(items, len(items))
    assert [port._find(x) for x in order] == [jax_b._find(x) for x in order]
    parent = port._parent
    assert all(parent[x] == port._find(x) for x in parent)
    # the chain's first node walks to its root in one step
    first = chain[0]
    assert parent[first] == port._find(first) == jax_b._find(first)
