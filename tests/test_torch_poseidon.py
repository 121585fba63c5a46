"""The port's Poseidon, sponges and Merkle trees against the JAX package.

Exact equality everywhere (tolerance 0): hashing is integer arithmetic.
The JAX permutation is run through its XLA path and, in a `slow` test,
through the Pallas kernel K1 in interpret mode (how the JAX package's own
CPU tests run it), since the port's CUDA kernel replaces that kernel.  On
the CPU the port's kernel wrapper runs its plain torch version; the
card-side check of the CUDA kernel against that plain version is
`chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.field import gl as jgl
from plonky2_tpu.hashes import poseidon as jpos
from plonky2_tpu.hashes.pallas_poseidon import permute_cols_pallas
from plonky2_tpu.merkle import MerkleTree as JMerkleTree
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch.hashes import cuda_poseidon, poseidon
from plonky2_tpu_torch.merkle import MerkleTree, verify_merkle_proof_s

RNG = np.random.RandomState(0x5EED)


def rand_u64(*shape):
    x = RNG.randint(0, 2**63, size=shape, dtype=np.int64).astype(np.uint64)
    return (x * np.uint64(2) + np.uint64(1)) % np.uint64(gl.P)


def test_constants_equal_jax():
    assert poseidon.ROUND_CONSTANTS == jpos.ROUND_CONSTANTS
    assert poseidon.MDS == jpos.MDS
    assert poseidon.MDS_SMALL == jpos._MDS_SMALL
    assert (poseidon.WIDTH, poseidon.RATE, poseidon.N_ROUNDS) == \
        (jpos.WIDTH, jpos.RATE, jpos.N_ROUNDS)


def _states():
    s = rand_u64(12, 256)
    s[:, 0] = 0
    s[:, 1] = gl.P - 1
    return s


def test_permute_cols_equals_jax():
    s = _states()
    got = gl.from_tensor(poseidon.permute_cols(gl.to_tensor(s)))
    assert np.array_equal(got, np.asarray(jpos.permute_cols(jnp.asarray(s))))
    for col in (0, 1, 77):
        assert got[:, col].tolist() == jpos.permute_s([int(x) for x in s[:, col]])


@pytest.mark.slow
def test_permute_cols_equals_pallas_interpret():
    # ~40 s on one core, all of it the interpret-mode compile of the JAX
    # kernel; tests/test_pallas_interpret.py pins that kernel to
    # jpos.permute_cols, which the test above compares with.
    s = _states()
    got = gl.from_tensor(poseidon.permute_cols(gl.to_tensor(s)))
    assert np.array_equal(got, np.asarray(permute_cols_pallas(jnp.asarray(s),
                                                              interpret=True)))


def test_permute_scalar_equals_jax():
    state = [int(x) for x in rand_u64(12)]
    assert poseidon.permute_s(state) == jpos.permute_s(state)
    assert poseidon.two_to_one_s(state[:4], state[4:8]) == \
        jpos.two_to_one_s(state[:4], state[4:8])
    assert poseidon.hash_no_pad_s(state + state[:5]) == \
        jpos.hash_no_pad_s(state + state[:5])


def _dense_permute_s(state, rc, mds):
    """Poseidon with these constants and this matrix, every round dense."""
    P = gl.P
    s = list(state)
    for r in range(poseidon.N_ROUNDS):
        s = [(x + c) % P for x, c in zip(s, rc[r])]
        full = r < 4 or r >= 4 + poseidon.PARTIAL_ROUNDS
        s = [pow(x, 7, P) if full or i == 0 else x for i, x in enumerate(s)]
        s = [sum(m * x for m, x in zip(row, s)) % P for row in mds]
    return s


def _fast_permute_s(state, rc, mds):
    """The same permutation with the partial rounds in the fast form of
    `poseidon.fast_partial_tables`, written out as the kernel runs it."""
    P = gl.P
    t = poseidon.fast_partial_tables(rc, mds)

    def full_round(s, r):
        s = [pow((x + c) % P, 7, P) for x, c in zip(s, rc[r])]
        return [sum(m * x for m, x in zip(row, s)) % P for row in mds]

    s = list(state)
    for r in range(4):
        s = full_round(s, r)
    s = [(x + c) % P for x, c in zip(s, t["first"])]
    s = [s[0]] + [sum(m * x for m, x in zip(row, s[1:])) % P for row in t["initial"]]
    for i in range(poseidon.PARTIAL_ROUNDS):
        s0 = (pow(s[0], 7, P) + t["post"][i]) % P
        new0 = (t["m00"][i] * s0 + sum(v * x for v, x in zip(t["v"][i], s[1:]))) % P
        s = [new0] + [(x + w * s0) % P for x, w in zip(s[1:], t["w"][i])]
    for r in range(4 + poseidon.PARTIAL_ROUNDS, poseidon.N_ROUNDS):
        s = full_round(s, r)
    return s


def _cauchy_mds_and_constants(seed):
    """A 12 x 12 Cauchy matrix 1 / (x_i - y_j) over distinct x and y, which
    is MDS, and random round constants."""
    rng = np.random.RandomState(seed)
    xy = []
    while len(xy) < 24:
        v = int(rng.randint(0, 2**62)) * 3 % gl.P
        if v not in xy:
            xy.append(v)
    x, y = xy[:12], xy[12:]
    mds = [[pow((a - b) % gl.P, gl.P - 2, gl.P) for b in y] for a in x]
    rc = [[int(v) for v in row] for row in rand_u64(poseidon.N_ROUNDS, 12)]
    return rc, mds


EDGE_STATES = [[v] * 12 for v in (0, 1, 2**32, 2**63, gl.P - 1)]


@pytest.mark.parametrize("matrix", ["plonky2", "cauchy"])
def test_fast_partial_rounds_equal_dense(matrix):
    # plonky2's matrix: against the JAX scalar permutation.  A Cauchy matrix
    # with random constants covers the derivation for a dense, large-entry
    # matrix, against a dense permutation with that matrix.
    if matrix == "plonky2":
        rc, mds, want = poseidon.ROUND_CONSTANTS, poseidon.MDS, jpos.permute_s
    else:
        rc, mds = _cauchy_mds_and_constants(11)
        assert max(max(row) for row in mds) >= 1 << 20
        want = lambda s: _dense_permute_s(s, rc, mds)      # noqa: E731
    t = poseidon.fast_partial_tables(rc, mds)
    assert t["m00"] == [mds[0][0]] * poseidon.PARTIAL_ROUNDS and t["post"][-1] == 0
    states = EDGE_STATES + [[int(v) for v in col] for col in rand_u64(12, 24).T]
    for s in states:
        assert _fast_permute_s(s, rc, mds) == want(s)


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    s = gl.to_tensor(rand_u64(12, 8))
    before = cuda_poseidon.LAUNCHES
    assert torch.equal(poseidon.permute_cols(s), poseidon.permute_cols_plain(s))
    assert cuda_poseidon.LAUNCHES == before          # CPU: no kernel launch
    with pytest.raises(ValueError):
        poseidon.permute_cols(torch.empty((12, 8), dtype=torch.int64,
                                          device="meta"))


@pytest.mark.parametrize("C", [4, 9, 136])
def test_cols_sponges_equal_jax(C):
    x = rand_u64(C, 64)
    xt, xj = gl.to_tensor(x), jnp.asarray(x)
    want = np.asarray(jpos.hash_or_noop_cols(xj))
    assert np.array_equal(gl.from_tensor(poseidon.hash_or_noop_cols(xt)), want)
    if C > poseidon.HASH_OUT:      # hash_or_noop is the sponge itself here
        assert np.array_equal(gl.from_tensor(poseidon.hash_no_pad_cols(xt)), want)
    if C == 9:                     # squeezing past one rate block
        assert np.array_equal(gl.from_tensor(poseidon.hash_no_pad_cols(xt, 12)),
                              np.asarray(jpos.hash_no_pad_cols(xj, 12)))
    if C == 4:
        y = rand_u64(4, 64)
        assert np.array_equal(
            gl.from_tensor(poseidon.two_to_one_cols(xt, gl.to_tensor(y))),
            np.asarray(jpos.two_to_one_cols(xj, jnp.asarray(y))))


def test_merkle_cap_and_openings_equal_jax():
    leaves = rand_u64(20, 512)
    tree = MerkleTree.build_cols(gl.to_tensor(leaves), 2, poseidon)
    jtree = JMerkleTree.build_cols(jnp.asarray(leaves), 2)
    assert tree.cap_host() == jtree.cap_host()
    idx = np.asarray([0, 1, 5, 255, 256, 511, 77], dtype=np.int64)
    lv, sib = tree.open_many(idx)
    jlv, jsib = jtree.open_many(idx)
    assert np.array_equal(lv, np.asarray(jlv))
    assert np.array_equal(sib, np.asarray(jsib))
    assert lv.shape == (7, 24) and sib.shape == (7, 7, 4)   # 20 cols padded to 24
    for q, i in enumerate(idx):
        assert verify_merkle_proof_s([int(v) for v in lv[q]], int(i),
                                     tree.cap_host(), sib[q].tolist(), poseidon)
    bad = [int(v) for v in lv[0]]
    bad[3] = (bad[3] + 1) % jgl.P
    assert not verify_merkle_proof_s(bad, 0, tree.cap_host(), sib[0].tolist(), poseidon)
