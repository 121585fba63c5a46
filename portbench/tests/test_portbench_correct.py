"""`correct` on the CPU at a small size: the reference gives the program's
bytes, the control (27 FRI queries of 28) fails the comparison, and a run
whose timed path is broken underneath reads `correct` false.  The runs skip
the harness's look for a card (`run_cell(device="cpu")`) and prove the
SMT process circuit at 2^7 rows (the ECDSA circuit has no smaller size:
its faults go through the same loop and the same judge)."""

import dataclasses
import random

import pytest
import torch

from portbench import control, run
from plonky2_tpu_torch.prove import prover

CELL = "smt-x51.seq"
# The SMT process circuit at 2^7 rows: 2 transitions of depth 4, test_config.
TINY_SMT = {"builder": "smt_process", "degree_bits": 7, "n_levels": 4,
            "circuit_config": "test_config"}
TINY_SMT_SIZES = {"degree_bits": 7, "n_levels": 4, "input_values": 86}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell(seed, seconds=0.05):
    return run.run_cell(CELL, seed, seconds, False, device="cpu", circuit=TINY_SMT,
                        sizes=TINY_SMT_SIZES)


def test_sound_run_is_correct_and_control_is_not():
    r = cell(2**31 + 11)
    assert r["correct"] and r["failed"] == 0
    assert r["compared"]["proofs_differing"]["value"] == 0
    out = control.readings(CELL, [], [5, 2**35 + 1], device="cpu", circuit=TINY_SMT,
                           sizes=TINY_SMT_SIZES)
    assert [c[1] for c in out["control"]] == [1, 1]
    assert all(c[2] == ["fri.query_rounds"] for c in out["control"])


def _patched(monkeypatch, fault):
    """The program's prove with `fault` in it from the window on (set-up's
    two proofs run sound)."""
    real = prover.prove
    state = {"calls": 0}

    def prove(pd, inputs, mesh=None):
        state["calls"] += 1
        if state["calls"] <= 2:
            state["last"] = real(pd, inputs)
            return state["last"]
        return fault(real, pd, inputs, state)
    monkeypatch.setattr(prover, "prove", prove)


def stale(real, pd, inputs, state):
    """A step that returns its state unchanged: the last proof again."""
    last, state["last"] = state["last"], real(pd, inputs)
    return last


def altered(real, pd, inputs, state):
    """An answer altered where it is produced: one opening value."""
    proof = real(pd, inputs)
    (a, b), *rest = proof.openings.wires
    openings = dataclasses.replace(proof.openings, wires=[((a + 1) % (2**64 - 2**32 + 1), b)]
                                   + rest)
    return dataclasses.replace(proof, openings=openings)


def half_batch(real, pd, inputs, state):
    """Half of the batch left out: the second transition's inputs are the
    first one's."""
    items = list(inputs.items())
    half = len(items) // 2
    kept = dict(items[:half])
    kept.update({t: v for (t, _), (_, v) in zip(items[half:], items[:half])})
    return real(pd, kept)


@pytest.mark.parametrize("fault", [stale, altered, half_batch], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _patched(monkeypatch, fault)
    r = cell(random.Random(fault.__name__).randrange(2**40))
    assert r["correct"] is False
    assert r["compared"]["proofs_differing"]["value"] >= 1 or r["failed"] >= 1
