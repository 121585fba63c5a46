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

`ShardedMerkleTree` is the same tree over leaves split into d contiguous
column shards of a device mesh (`parallel.mesh`): each shard hashes its
leaves and builds its own levels on its device, and the levels above the
shards (where d > 2^cap_height) are hashed on the mesh's first device.
Its cap, openings and commitment are those of `MerkleTree` on the whole
leaf matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..field import gl
from ..hashes import poseidon
from ..utils.timing import timed_span


def _reduce_levels(levels: list, width: int, hasher) -> list:
    """Append two_to_one levels to `levels` until the last is `width` wide."""
    while levels[-1].shape[1] > width:
        cur = levels[-1]
        levels.append(hasher.two_to_one_cols(cur[:, 0::2], cur[:, 1::2]))
    return levels


def _merkle_levels(leaves_cols, cap_height: int, hasher):
    return _reduce_levels([hasher.hash_or_noop_cols(leaves_cols)], 1 << cap_height, hasher)


def _pad_to_rate(leaves_cols, hasher):
    """Columns are padded to the sponge rate, as in the JAX package (it
    shares compiled leaf-hash kernels that way); the zero rows are bound by
    the commitment and ignored by every consumer."""
    C, L = leaves_cols.shape
    if C > hasher.HASH_OUT and C % hasher.RATE:
        pad = hasher.RATE - C % hasher.RATE
        leaves_cols = torch.cat(
            [leaves_cols, torch.zeros((pad, L), dtype=leaves_cols.dtype,
                                      device=leaves_cols.device)], dim=0)
    return leaves_cols


def _check_leaf_count(L: int, cap_height: int) -> None:
    if L & (L - 1) or (1 << cap_height) > L:
        raise ValueError(f"need a power-of-2 leaf count >= 2^cap_height, "
                         f"got L={L}, cap_height={cap_height}")


def sharded_levels(device0, leaf_hashes: list, cap_height: int, hasher):
    """The levels of a tree whose leaf hashes [4, L/d] lie in d contiguous
    shards -> (local, top): each shard's levels on its device, down to
    max(1, 2^cap_height / d) digests, then the top levels on `device0`:
    top[0] the shards' last local levels side by side, down to top[-1],
    the cap [4, 2^cap_height].  Where d <= 2^cap_height, top[0] is the cap
    and nothing is hashed across shards."""
    d = len(leaf_hashes)
    local_width = max(1, (1 << cap_height) // d)
    local = [_reduce_levels([h], local_width, hasher) for h in leaf_hashes]
    top = [torch.cat([lv[-1].to(device0) for lv in local], dim=1)]
    return local, _reduce_levels(top, 1 << cap_height, hasher)


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
        L = leaves_cols.shape[1]
        _check_leaf_count(L, cap_height)
        leaves_cols = _pad_to_rate(leaves_cols, hasher)
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
    return gl.from_tensor(lv), _gather_siblings(levels, idx)


def _gather_siblings(levels, idx):
    """The sibling path of each index [Q] up through `levels` -> [Q, D, 4]
    numpy uint64."""
    sibs = []
    cur = idx
    for lvl in levels:
        sibs.append(lvl.index_select(1, cur ^ 1).T)             # [Q, 4]
        cur = cur >> 1
    if sibs:
        sib_arr = torch.stack(sibs, dim=1)                      # [Q, D, 4]
    else:
        sib_arr = torch.zeros((idx.shape[0], 0, poseidon.HASH_OUT),
                              dtype=gl.DTYPE, device=idx.device)
    return gl.from_tensor(sib_arr)


@dataclass
class ShardedMerkleTree:
    """A `MerkleTree` over leaves [C, L] held as d contiguous column shards
    [C, L/d] on the devices of a mesh: shards[i] and local[i] (its levels,
    local[i][0] its leaf hashes) on devices[i], the top levels on
    devices[0] (`sharded_levels`).  Same cap, openings and commitment as
    `MerkleTree.build_cols` of the whole matrix."""

    shards: list
    local: list
    top: list
    cap_height: int
    _cap_host_cache: list | None = None

    @staticmethod
    def build_cols(mesh, shards: list, cap_height: int, hasher) -> "ShardedMerkleTree":
        """shards: the mesh's d row shards [C, L/d] of the leaf columns (shard
        i on mesh.devices[i]); `hasher` the config's transcript module.
        Each shard is padded to the sponge rate as `MerkleTree.build_cols`
        pads the whole matrix."""
        C, Ls = shards[0].shape
        if len(shards) != mesh.size or any(s.shape != (C, Ls) for s in shards):
            raise ValueError(f"need {mesh.size} leaf shards of one shape, got "
                             f"{[tuple(s.shape) for s in shards]}")
        _check_leaf_count(Ls * mesh.size, cap_height)
        shards = [_pad_to_rate(s, hasher) for s in shards]
        with timed_span(f"Merkle tree ({hasher.__name__.rsplit('.', 1)[-1]}, "
                        f"[{shards[0].shape[0]}, {Ls * mesh.size}] leaves, "
                        f"{mesh.size} shards)"):
            local, top = sharded_levels(mesh.devices[0],
                                        [hasher.hash_or_noop_cols(s) for s in shards],
                                        cap_height, hasher)
        return ShardedMerkleTree(shards=shards, local=local, top=top,
                                 cap_height=cap_height)

    @property
    def cap(self):
        """Device cap tensor [2^cap_height, 4], on the mesh's first device."""
        return self.top[-1].T

    def cap_host(self) -> list[list[int]]:
        if self._cap_host_cache is None:
            self._cap_host_cache = [[int(x) for x in row]
                                    for row in gl.from_tensor(self.cap)]
        return self._cap_host_cache

    def open_many(self, indices):
        """`MerkleTree.open_many`: index i opens in shard i // (L/d), its
        sibling path the shard's own levels, then the top levels."""
        idx = np.asarray(indices, dtype=np.int64)
        Ls = self.shards[0].shape[1]
        shard_of = idx // Ls
        leaves = np.empty((len(idx), self.shards[0].shape[0]), dtype=np.uint64)
        d_local = len(self.local[0]) - 1
        sibs = np.empty((len(idx), d_local + len(self.top) - 1, poseidon.HASH_OUT),
                        dtype=np.uint64)
        for s in np.unique(shard_of):
            sel = np.nonzero(shard_of == s)[0]
            lv, sib = _gather_openings(self.shards[s], self.local[s][:-1],
                                       idx[sel] - s * Ls)
            leaves[sel] = lv
            sibs[sel, :d_local] = sib
        top_idx = torch.as_tensor(shard_of, device=self.top[0].device)
        sibs[:, d_local:] = _gather_siblings(self.top[:-1], top_idx)
        return leaves, sibs


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
