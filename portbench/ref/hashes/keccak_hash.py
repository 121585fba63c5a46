"""Keccak-based transcript and Merkle hasher: the KeccakGoldilocksConfig slot.

Counterpart of `plonky2_tpu/hashes/keccak_hash.py`.  The reference proves
its Keccak circuits under `KeccakGoldilocksConfig`: Keccak hashes the
Merkle caps, the Fiat-Shamir transcript and the proof-of-work grind, and
Poseidon stays the in-circuit hasher.  As plonky2's KeccakPermutation, the
state transform is a PRF over the sponge state, not a bit permutation:

    state12  ->  the first 12 lanes of keccak-f1600(state12 || 13 zero
                 lanes), each lane reduced mod p,

with the width-12 / rate-8 / 4-element-digest sponge of hashes/poseidon.py,
so the challenger, the Merkle trees and FRI take either module.

Two implementations, tested against each other and against the JAX
package: scalar (Python ints, through `gadgets.keccak.keccak_f1600_host`)
and lanes-first tensors [25, B].  The JAX package's column form is XLA, not
a Pallas kernel, so the port's is plain torch on every device.  A round
acts on the whole [25, B] state at once: theta on [5, 5, B] views, rho as
one shift by a [25, 1] offset tensor (the right shift masked, since int64
`>>` is arithmetic), pi as one row gather, chi on rolled views; about 25
launches a round.
"""

from __future__ import annotations

import functools

import torch

from ..field import gl
from ..gadgets import keccak as _kk

WIDTH = 12
RATE = 8
HASH_OUT = 4
LANES = 25


# ------------------------------------------------------------------
# scalar
# ------------------------------------------------------------------

def permute_s(state: list[int]) -> list[int]:
    if len(state) != WIDTH:
        raise ValueError(f"state has {len(state)} elements, want {WIDTH}")
    lanes = [int(x) & gl.MASK64 for x in state] + [0] * (LANES - WIDTH)
    out = _kk.keccak_f1600_host(lanes)
    return [v % gl.P for v in out[:WIDTH]]


# ------------------------------------------------------------------
# lanes-first tensors: keccak-f1600 on [25, B] int64 lanes holding u64
# ------------------------------------------------------------------

def _rot_table() -> list[int]:
    """Rotation offset of the lane at position x + 5y, from the gadget's
    rho-pi walk: the lane the walk leaves at step i (lane 1 before the
    first step, `PILN[i - 1]` after) rotates by `ROTC[i]`."""
    rot = [0] * LANES
    for i, r in enumerate(_kk.ROTC):
        rot[_kk.PILN[i - 1]] = r
    return rot


ROT = _rot_table()


def _pi_source() -> list[int]:
    """rho + pi: lane (x, y) moves to (y, 2x + 3y); entry dst is its
    source lane."""
    src = [0] * LANES
    for y in range(5):
        for x in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


PI_SRC = _pi_source()


@functools.lru_cache(maxsize=None)
def _tables(device) -> tuple:
    """(rotation offsets [25, 1], the low-bit masks of the right shift
    [25, 1], the pi gather index [25], the round constants [24])."""
    rot = torch.tensor(ROT, dtype=gl.DTYPE, device=device)[:, None]
    mask = torch.tensor([(1 << r) - 1 for r in ROT], dtype=gl.DTYPE,
                        device=device)[:, None]
    pi = torch.tensor(PI_SRC, dtype=torch.int64, device=device)
    rc = gl.to_tensor(_kk.RNDC, device)
    return rot, mask, pi, rc


def _rotl1(x):
    return (x << 1) | ((x >> 63) & 1)


def f1600_cols(lanes):
    """keccak-f[1600]: lanes [25, B] -> [25, B] (24 rounds)."""
    rot, mask, pi, rc = _tables(lanes.device)
    s = lanes
    B = s.shape[1]
    for rnd in range(24):
        # theta: c[x] = xor over y of a[x, y]; a[x, y] ^= c[x-1] ^ rotl(c[x+1], 1)
        s5 = s.view(5, 5, B)                         # [y, x, B]
        c = s5[0] ^ s5[1] ^ s5[2] ^ s5[3] ^ s5[4]    # [x, B]
        d = torch.roll(c, 1, 0) ^ _rotl1(torch.roll(c, -1, 0))
        s = (s5 ^ d[None]).view(LANES, B)
        # rho: every lane rotated left by its offset; pi: one row gather
        s = (s << rot) | ((s >> (64 - rot)) & mask)
        s = s.index_select(0, pi)
        # chi: a[x] ^= ~a[x+1] & a[x+2] within each row y
        s5 = s.view(5, 5, B)
        s = (s5 ^ (~torch.roll(s5, -1, 1) & torch.roll(s5, -2, 1))).view(LANES, B)
        # iota
        s[0] ^= rc[rnd]
    return s


# On the CPU the permutation runs in column blocks of this many states,
# which stay in cache (2.4x faster than 2^16 columns at once on one core).
CPU_BLOCK = 1 << 12


def permute_cols(state):
    """state [12, B] -> [12, B]: keccak-f1600 over the zero-extended lanes,
    the first 12 lanes reduced mod p."""
    B = state.shape[1]
    if state.device.type == "cpu" and B > CPU_BLOCK:
        return torch.cat([permute_cols(c) for c in state.split(CPU_BLOCK, 1)], 1)
    z = torch.zeros((LANES - WIDTH, B), dtype=gl.DTYPE, device=state.device)
    out = f1600_cols(torch.cat([state, z], dim=0))[:WIDTH]
    # out < 2^64 < 2p: one conditional subtraction reduces it
    return gl._canon(out)


# ------------------------------------------------------------------
# sponge, scalar (the discipline of hashes/poseidon.py)
# ------------------------------------------------------------------

def hash_n_to_m_no_pad_s(inputs: list[int], num_outputs: int = HASH_OUT) -> list[int]:
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i:i + RATE]
        state[: len(chunk)] = chunk
        state = permute_s(state)
    outputs: list[int] = []
    while True:
        outputs.extend(state[:RATE])
        if len(outputs) >= num_outputs:
            return outputs[:num_outputs]
        state = permute_s(state)


def hash_no_pad_s(inputs: list[int]) -> list[int]:
    return hash_n_to_m_no_pad_s(inputs, HASH_OUT)


def two_to_one_s(x: list[int], y: list[int]) -> list[int]:
    if len(x) != HASH_OUT or len(y) != HASH_OUT:
        raise ValueError("two_to_one takes two 4-element digests")
    return permute_s(list(x) + list(y) + [0] * (WIDTH - 2 * HASH_OUT))[:HASH_OUT]


def hash_or_noop_s(inputs: list[int]) -> list[int]:
    if len(inputs) <= HASH_OUT:
        return list(inputs) + [0] * (HASH_OUT - len(inputs))
    return hash_no_pad_s(inputs)


# ------------------------------------------------------------------
# sponge, lanes-first: [L, B] inputs, [4, B] digests
# ------------------------------------------------------------------

def hash_no_pad_cols(inputs, num_outputs: int = HASH_OUT):
    """inputs [L, B] -> [num_outputs, B]: absorb rate-sized row chunks by
    overwriting state rows, one permutation per chunk."""
    L, B = inputs.shape
    state = torch.zeros((WIDTH, B), dtype=gl.DTYPE, device=inputs.device)
    for i in range(0, L, RATE):
        chunk = inputs[i:i + RATE]
        state = permute_cols(torch.cat([chunk, state[chunk.shape[0]:]], dim=0))
    outs = [state[:RATE]]
    have = RATE
    while have < num_outputs:
        state = permute_cols(state)
        outs.append(state[:RATE])
        have += RATE
    return torch.cat(outs, dim=0)[:num_outputs]


def two_to_one_cols(x, y):
    """x, y [4, B] -> [4, B]."""
    z = torch.zeros((WIDTH - 2 * HASH_OUT, x.shape[1]), dtype=gl.DTYPE,
                    device=x.device)
    return permute_cols(torch.cat([x, y, z], dim=0))[:HASH_OUT]


def hash_or_noop_cols(inputs):
    L = inputs.shape[0]
    if L <= HASH_OUT:
        pad = torch.zeros((HASH_OUT - L, inputs.shape[1]), dtype=gl.DTYPE,
                          device=inputs.device)
        return torch.cat([inputs, pad], dim=0)
    return hash_no_pad_cols(inputs)
