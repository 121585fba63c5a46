"""Tier-1's `slow` set and its per-test time limit, for the tests in `tests/`.

`pytest.ini` beside this file makes this directory pytest's rootdir, so this
conftest loads, ahead of `tests/conftest.py`, for `pytest tests/`.  Tier-1
runs `-m 'not slow'`; `pytest tests/ -m slow` runs the slow set.
"""
import faulthandler
import os
import signal
import time
from pathlib import Path

import pytest

TESTS_DIR = Path(__file__).resolve().parent / "tests"

# The JAX package's circuit proves on XLA:CPU that took more than 60 s in a
# timed run of tier-1 (6 xdist workers), in files not named `test_torch_*`
# that do not import `plonky2_tpu_torch`.  The port's tests still run each
# JAX function they compare against.  The five proves of `test_ecdsa.py`,
# `test_keccak.py` and `test_zkaa.py` that a `skipif` gates on
# PLONKY2_TPU_SLOW_TESTS=1 are here too, and still need that variable to run.
SLOW = frozenset(f"{module}.py::{test}" for module, tests in {
    "test_biguint": ["test_biguint_mul_u32_and_bits", "test_biguint_ops_prove_verify"],
    "test_curve": ["test_curve_ops_prove_verify", "test_glv_decompose_gadget"],
    "test_ecdsa": ["test_ecdsa_prove_verify_slow"],
    "test_extension_gates": ["test_coset_interpolation_circuit",
                             "test_extension_arithmetic_circuit",
                             "test_reducing_gates_circuit"],
    "test_fri": ["test_fri_rejects_corrupt_query_eval", "test_fri_roundtrip"],
    "test_golden_vectors": ["test_golden_vectors_stable"],
    "test_keccak": ["test_keccak256_long_circuit_ethereum_vectors_slow",
                    "test_keccak256_one_block_prove",
                    "test_keccak256_short_circuit_ethereum_vectors_slow",
                    "test_one_theta_chi_round_circuit"],
    "test_keccak_config": ["test_prove_verify_under_keccak_transcript"],
    "test_lookup": ["test_lookup_prove_verify", "test_lookup_rejects_tampered_output",
                    "test_lookup_rejects_wrong_multiplicities"],
    "test_multichip": ["test_mesh_prove_bit_identical",
                       "test_mesh_prove_bit_identical_hard_gates"],
    "test_new_gates": ["test_comparison_circuit", "test_exponentiation_circuit",
                       "test_random_access_circuit", "test_u32_subtraction_circuit"],
    "test_nonnative": ["test_nonnative_conditionals_and_splits",
                       "test_nonnative_ops_prove_verify"],
    "test_pallas_interpret": ["test_pallas_lde_tiled_interpret_bit_exact"],
    "test_poseidon2": ["test_poseidon2_circuit_oracle"],
    "test_prover": ["test_arithmetic_prove_verify", "test_connect_constraints_copy",
                    "test_hash_chain_circuit", "test_poseidon_gate_circuit"],
    "test_prover_serde": ["test_prover_data_roundtrip_then_prove"],
    "test_recursion": ["test_circuit_alg_matches_ext_alg", "test_merkle_proof_circuit",
                       "test_recursive_challenger_matches_host"],
    "test_recursion_e2e": ["test_recursive_verification_e2e",
                           "test_recursive_verifier_rejects_tampered_proof"],
    "test_serialization": ["test_corrupt_proof_rejected",
                           "test_proof_roundtrip_and_cross_verify"],
    "test_smt_circuit": ["test_smt_inclusion_circuit", "test_smt_process_circuit_all_roles",
                         "test_smt_transition_and_layered_connection_circuit"],
    "test_timing": ["test_prover_phases_logged"],
    "test_u32": ["test_u32_ops_prove_verify", "test_u64_ops_prove_verify"],
    "test_zkaa": ["test_aggregate_four_zkdsa_proofs_slow", "test_aggregate_two_zkdsa_proofs"],
    "test_zkdsa": ["test_simple_signature_circuit"],
}.items() for test in tests)

# Each test in `tests/` that is not `slow` gets TEST_TIME_LIMIT_S for set-up,
# call and teardown together.  SIGALRM, armed only while a phase runs, fails
# the phase that passes the limit; later phases run unarmed, and the worker
# goes on to its next test.  A test stuck in C code, where the alarm's handler
# cannot run, has every thread's stack written and its worker ended at twice
# the limit; xdist reports the test as failed and starts a new worker.  The
# limit is twice the slowest tier-1 test, 165.1 s on six workers of an 8-core
# CPU (`test_torch_smt.py::test_small_smt_proof_matches_fixture`).
TEST_TIME_LIMIT_S = 340

_DEADLINE = pytest.StashKey[float]()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # Ahead of `-m`'s deselection, which reads the marks.
    for item in items:
        if not item.path.is_relative_to(TESTS_DIR):
            continue
        name = getattr(item, "originalname", item.name)
        if f"{item.path.relative_to(TESTS_DIR)}::{name}" in SLOW:
            item.add_marker(pytest.mark.slow)


def pytest_configure(config):
    # The stacks go to the run's stderr, not to the capture file that
    # stands in for fd 2 while a test runs.
    global _STDERR_FD
    _STDERR_FD = os.dup(2)


def _over_time_limit(signum, frame):
    pytest.fail(f"ran past the per-test time limit of {TEST_TIME_LIMIT_S} s",
                pytrace=False)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not item.path.is_relative_to(TESTS_DIR) or item.get_closest_marker("slow"):
        return (yield)
    item.stash[_DEADLINE] = time.monotonic() + TEST_TIME_LIMIT_S
    faulthandler.dump_traceback_later(2 * TEST_TIME_LIMIT_S, exit=True,
                                      file=_STDERR_FD)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


# Innermost, so that the alarm falls in the test's own code and fixtures,
# not in pytest's capture, logging or report hooks around them.
@pytest.hookimpl(wrapper=True, trylast=True)
def _alarm_until_deadline(item):
    left = item.stash.get(_DEADLINE, 0.0) - time.monotonic()
    if left <= 0:
        return (yield)
    signal.signal(signal.SIGALRM, _over_time_limit)
    signal.setitimer(signal.ITIMER_REAL, left)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _alarm_until_deadline
