"""The input makers: signatures that verify in plain ints, SMT batches
whose transitions chain root to root, the same values from the same seed."""

import random

import pytest

from portbench import spec
from portbench.ref.field import secp
from portbench.ref.smt.proof import verify_smt_process_proof

SPEC = spec.load_spec()


def maker(name):
    return spec.Config(spec.by_name(SPEC["configs"], name, "configuration")).module("inputs")


def test_ecdsa_signatures_verify():
    ecdsa = maker("ecdsa-secp256k1-b1")
    rng = random.Random(2**33 + 5)
    for _ in range(3):
        h, sig, pk = ecdsa.signature(rng)
        assert secp.verify(h, sig, pk)
        assert not secp.verify((h + 1) % secp.N, sig, pk)
    values = ecdsa.make(random.Random(7), {"input_values": 40})
    assert len(values) == 40 and all(0 <= v < 2**32 for v in values)
    assert values == ecdsa.make(random.Random(7), {"input_values": 40})
    assert values != ecdsa.make(random.Random(8), {"input_values": 40})


def test_smt_batches_chain_from_root_to_root():
    smt = maker("smt-process-d32-x51")
    proofs = smt.transitions(random.Random(2**40 + 3), 6)
    for a, b in zip(proofs, proofs[1:]):
        assert a.new_root == b.old_root
    assert [p.fnc.name for p in proofs] == ["Insert", "Update", "Insert"] * 2
    for p in proofs:
        assert len(smt.flatten(p, 32)) == smt.values_per_transition(32)
    sizes = {"n_levels": 4, "input_values": 2 * smt.values_per_transition(4)}
    assert smt.make(random.Random(9), sizes) == smt.make(random.Random(9), sizes)


def test_smt_transitions_verify():
    smt = maker("smt-process-d32-x51")
    from portbench.ref.smt.tree import PoseidonNodeHash
    proofs = smt.transitions(random.Random(11), 3)
    for p in proofs:
        verify_smt_process_proof(PoseidonNodeHash, p, 32)
    bad = proofs[1]
    bad.new_value = (bad.new_value[0] + 1,) + tuple(bad.new_value[1:])
    with pytest.raises(ValueError):
        verify_smt_process_proof(PoseidonNodeHash, bad, 32)
