"""In-circuit Merkle path verification against a cap.

Host copy of `plonky2_tpu/recursion/merkle.py`: the recursive verifier's
check of FRI initial and step openings (plonky2's
`verify_merkle_proof_to_cap_circuit`).  Each level is ONE Poseidon(2) gate: the gate's built-in swap wire
conditionally exchanges the running digest with the sibling before
compressing, so a depth-d path costs d hash gates plus one RandomAccessGate
per digest lane to pick the cap entry.
"""

from __future__ import annotations


def verify_merkle_proof_to_cap_circuit(b, leaf_values: list, index_bits: list,
                                       cap: list, siblings: list) -> None:
    """Constrain that `leaf_values` sits at the index given by LSB-first
    `index_bits` in a tree whose cap (list of 4-target digests) is `cap`.

    len(index_bits) must equal len(siblings) + log2(len(cap)): the low bits
    steer the sibling swaps, the high bits select the cap entry (mirrors
    merkle.py's host `verify_merkle_proof_s`).
    """
    zero = b.zero()
    if len(leaf_values) <= 4:
        state = list(leaf_values) + [zero] * (4 - len(leaf_values))
    else:
        state = b.hash_n_to_hash_no_pad(list(leaf_values))
    if len(index_bits) != len(siblings) + (len(cap) - 1).bit_length():
        raise ValueError(f"{len(index_bits)} index bits for {len(siblings)} "
                         f"siblings and a cap of {len(cap)}")
    for bit, sib in zip(index_bits, siblings):
        if len(sib) != 4:
            raise ValueError(f"sibling digest has {len(sib)} elements")
        inputs = state + list(sib) + [zero] * 4
        state = b.permute_swapped(inputs, bit)[:4]
    cap_bits = index_bits[len(siblings):]
    if len(cap) == 1:
        entry = list(cap[0])
    else:
        # path bits are forced boolean by the Poseidon swap wire; cap bits
        # only pass through le_sum, so constrain them here
        for cb in cap_bits:
            b.assert_bool(cb)
        idx = b.le_sum(cap_bits)
        entry = [b.random_access(idx, [c[i] for c in cap]) for i in range(4)]
    for s, e in zip(state, entry):
        b.connect(s, e)
