"""Cap-rooted Merkle commitments on torch tensors.

Counterpart of `plonky2_tpu/merkle/merkle.py`.  Leaves live as a [C, L]
column matrix (the layout polynomial oracles already have), leaf hashing
is the lanes-first sponge, each internal level one batched two_to_one over
[4, L/2^k] digests; every permutation runs on the tensors' device.  The
hasher is the config's transcript hasher: Poseidon (kernel K1 on the card)
or `hashes.keccak_hash` (plain torch).  The tree is truncated at
`cap_height`; the cap is the vector of 2^cap_height digests.  Openings are
one device gather per tree and one host transfer; verification is the host
scalar path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..field import gl
from ..hashes import poseidon
from ..utils.timing import timed_span


def _merkle_levels(leaves_cols, cap_height: int, hasher):
    levels = [hasher.hash_or_noop_cols(leaves_cols)]
    while levels[-1].shape[1] > (1 << cap_height):
        cur = levels[-1]
        levels.append(hasher.two_to_one_cols(cur[:, 0::2], cur[:, 1::2]))
    return levels


@dataclass
class MerkleTree:
    """leaves: [C, L] int64 tensor (column layout); levels[0] = leaf hashes
    [4, L] ... levels[-1] = cap [4, 2^cap_height]."""

    leaves: torch.Tensor
    cap_height: int
    levels: list = field(default_factory=list)
    _cap_host_cache: list | None = None

    @staticmethod
    def build_cols(leaves_cols, cap_height: int, hasher) -> "MerkleTree":
        """leaves_cols: [C, L] — one leaf per column; `hasher` is the
        config's transcript module (`CircuitConfig.transcript_module()`)."""
        C, L = leaves_cols.shape
        if L & (L - 1) or (1 << cap_height) > L:
            raise ValueError(f"need a power-of-2 leaf count >= 2^cap_height, "
                             f"got L={L}, cap_height={cap_height}")
        # Columns are padded to the sponge rate, as in the JAX package (it
        # shares compiled leaf-hash kernels that way); the zero rows are
        # bound by the commitment and ignored by every consumer.
        if C > hasher.HASH_OUT and C % hasher.RATE:
            pad = hasher.RATE - C % hasher.RATE
            leaves_cols = torch.cat(
                [leaves_cols, torch.zeros((pad, L), dtype=leaves_cols.dtype,
                                          device=leaves_cols.device)], dim=0)
        # the span names the hasher's module: "poseidon" or "keccak_hash"
        with timed_span(f"Merkle tree ({hasher.__name__.rsplit('.', 1)[-1]}, "
                        f"[{leaves_cols.shape[0]}, {L}] leaves)"):
            levels = _merkle_levels(leaves_cols, cap_height, hasher)
        return MerkleTree(leaves=leaves_cols, cap_height=cap_height, levels=levels)

    @property
    def cap(self):
        """Device cap tensor [2^cap_height, 4]."""
        return self.levels[-1].T

    def cap_host(self) -> list[list[int]]:
        if self._cap_host_cache is None:
            self._cap_host_cache = [[int(x) for x in row]
                                    for row in gl.from_tensor(self.cap)]
        return self._cap_host_cache

    def open_many(self, indices):
        """Batched openings: [Q] indices -> (leaves [Q, C], sibs [Q, D, 4])
        as numpy uint64 arrays, by one device gather per array and one
        host transfer each."""
        return _gather_openings(self.leaves, self.levels[:-1], indices)


def _gather_openings(leaves_cols, levels, indices):
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                          device=leaves_cols.device)
    lv = leaves_cols.index_select(1, idx).T                     # [Q, C]
    sibs = []
    cur = idx
    for lvl in levels:
        sibs.append(lvl.index_select(1, cur ^ 1).T)             # [Q, 4]
        cur = cur >> 1
    if sibs:
        sib_arr = torch.stack(sibs, dim=1)                      # [Q, D, 4]
    else:
        sib_arr = torch.zeros((idx.shape[0], 0, poseidon.HASH_OUT),
                              dtype=gl.DTYPE, device=leaves_cols.device)
    return gl.from_tensor(lv), gl.from_tensor(sib_arr)


def verify_merkle_proof_s(leaf_values: list[int], index: int, cap: list[list[int]],
                          siblings: list[list[int]], hasher) -> bool:
    """Scalar verification: recompute the path and compare the cap entry."""
    h = hasher.hash_or_noop_s(leaf_values)
    idx = index
    for sib in siblings:
        if idx & 1:
            h = hasher.two_to_one_s(sib, h)
        else:
            h = hasher.two_to_one_s(h, sib)
        idx >>= 1
    return h == list(cap[idx])
