"""The input maker of `smt-process-d32-x51`: a batch of chained sparse
Merkle tree process proofs, from the benchmark's plain SMT
(`portbench/ref/smt/`), drawn as BASELINE config 3 draws them: from an
empty tree, transition i inserts a fresh key (i % 3 == 0), updates the key
just inserted (1) or inserts another fresh key (2), each with a fresh
value.

`make(rng, sizes)` -> the circuit's input values in the order of its input
targets: per transition the `n_levels` siblings (zero-padded), then the old
root, new root, old key, old value, new key and new value (4 elements
each), then is_old0 and the two bits of its role.
"""

from __future__ import annotations

from portbench.ref.field import gl
from portbench.ref.smt import SparseMerkleTree
from portbench.ref.smt.hash_out import key_to_bits


def values_per_transition(n_levels: int) -> int:
    return 4 * n_levels + 6 * 4 + 3


def transitions(rng, count: int) -> list:
    """`count` process proofs of one tree, chained root to root."""
    def rand_hash():
        return tuple(rng.randrange(gl.P) for _ in range(4))

    tree = SparseMerkleTree()
    keys = [rand_hash() for _ in range(count)]
    proofs = []
    for i in range(count):
        op = i % 3
        if op == 0:
            proofs.append(tree.insert(keys[i], rand_hash()))
        elif op == 1:
            proofs.append(tree.update(keys[i - 1], rand_hash()))
        else:
            proofs.append(tree.insert(rand_hash(), rand_hash()))
    return proofs


def flatten(proof, n_levels: int) -> list[int]:
    """One transition's values in the order its targets take them; raises
    where the circuit's witness setter would refuse the proof."""
    if len(proof.siblings) >= n_levels:
        raise ValueError("siblings too long")
    if not proof.is_old0:
        a, b = key_to_bits(proof.old_key), key_to_bits(proof.new_key)
        idx = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if idx is not None and idx >= n_levels:
            raise ValueError("invalid new_key")
    out = []
    for i in range(n_levels):
        out += list(proof.siblings[i]) if i < len(proof.siblings) else [0] * 4
    for h in (proof.old_root, proof.new_root, proof.old_key, proof.old_value,
              proof.new_key, proof.new_value):
        out += list(h)
    f0, f1 = proof.fnc.bits
    return out + [int(proof.is_old0), int(f0), int(f1)]


def make(rng, sizes: dict) -> list[int]:
    n_levels = sizes["n_levels"]
    per = values_per_transition(n_levels)
    if sizes["input_values"] % per:
        raise ValueError(f"{sizes['input_values']} input values are not whole transitions")
    values = []
    for proof in transitions(rng, sizes["input_values"] // per):
        values += flatten(proof, n_levels)
    return values
