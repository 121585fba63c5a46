"""The port's layered SMTs (`plonky2_tpu_torch.smt.layered`) against the JAX
package's (`plonky2_tpu/smt/layered.py`).

Exact equality: host Poseidon hashes of Goldilocks ints.

* seeded set/find sequences on 2- and 3-level trees (insert, update,
  delete and no-op in `set`, then `find` of present and absent keys) give
  the JAX trees' process and inclusion proofs and roots;
* `verify_layered_smt_connection` accepts the upper/lower pair of every
  role that `set` produced, and raises ValueError on each role's pair with
  a lower root changed (the JAX function raises AssertionError there).
"""
import dataclasses
import enum

import numpy as np
import pytest

from plonky2_tpu import smt as jsmt
from plonky2_tpu_torch import smt
from plonky2_tpu_torch.field import gl

TREES = {2: (smt.LayeredSparseMerkleTree, jsmt.LayeredSparseMerkleTree),
         3: (smt.LayeredLayeredSparseMerkleTree,
             jsmt.LayeredLayeredSparseMerkleTree)}
ZERO = smt.ZERO_HASH


def _plain(proof):
    """A proof record as plain values (the two packages' enums differ)."""
    return {k: (v.name if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(proof).items()}


def _hashes(rng, n):
    v = rng.randint(0, 2**32, size=(n, 4, 2), dtype=np.int64).astype(object)
    v = (v[..., 0] * 2**32 + v[..., 1]) % gl.P
    return [tuple(int(x) for x in row) for row in v]


def _ops(levels: int):
    """(keys, value) steps: inserts, an update, a delete, a no-op delete
    of an absent key, an insert under a shared upper key."""
    rng = np.random.RandomState(0x1A7E + levels)
    keys = [tuple(_hashes(rng, levels)) for _ in range(4)]
    vals = _hashes(rng, 6)
    shared = keys[0][:-1] + (_hashes(rng, 1)[0],)
    return [(keys[0], vals[0]), (keys[1], vals[1]), (keys[0], vals[2]),
            (shared, vals[3]), (keys[1], ZERO), (keys[2], ZERO),
            (keys[3], vals[4]), (keys[0], ZERO)], keys + [shared]


@pytest.mark.parametrize("levels", [2, 3])
def test_set_find_equal_jax(levels):
    cls, jcls = TREES[levels]
    tree, jtree = cls(), jcls()
    steps, keys = _ops(levels)
    roles = set()
    for ks, value in steps:
        got = tree.set(*ks, value)
        want = jtree.set(*ks, value)
        assert [_plain(p) for p in got] == [_plain(p) for p in want]
        assert tree.get_root() == jtree.get_root()
        roles.update(p.fnc.name for p in got)
    assert roles == {"Insert", "Update", "Delete", "NoOp"}
    for ks in keys:
        got = tree.find(*ks)
        want = jtree.find(*ks)
        assert [_plain(p) for p in got] == [_plain(p) for p in want]


def _connections():
    """Every (upper proof, lower proof) pair of a 2-level tree's sets, one
    for each role of the upper proof."""
    tree = smt.LayeredSparseMerkleTree()
    steps, _ = _ops(2)
    pairs = {}
    for ks, value in steps:
        upper, lower = tree.set(*ks, value)
        pairs.setdefault(upper.fnc.name, (upper, lower))
    return pairs


@pytest.mark.parametrize("role", ["Insert", "Update", "Delete", "NoOp"])
def test_layered_connection_per_role(role):
    upper, lower = _connections()[role]
    args = (upper.fnc, upper.old_value, upper.new_value,
            lower.old_root, lower.new_root)
    smt.verify_layered_smt_connection(*args)
    jrole = jsmt.ProcessMerkleProofRole[role]
    jsmt.verify_layered_smt_connection(jrole, *args[1:])
    off = (1, 0, 0, 0)
    bumped = tuple((a + b) % gl.P for a, b in zip(lower.new_root, off))
    for bad in ((*args[:4], bumped),
                (*args[:3], tuple((a + b) % gl.P for a, b in
                                  zip(lower.old_root, off)), args[4])):
        with pytest.raises(ValueError):
            smt.verify_layered_smt_connection(*bad)
        with pytest.raises(AssertionError):
            jsmt.verify_layered_smt_connection(jrole, *bad[1:])
