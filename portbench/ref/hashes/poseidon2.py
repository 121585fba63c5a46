"""Poseidon2 permutation and sponge over Goldilocks, width 12.

Counterpart of `plonky2_tpu/hashes/poseidon2.py`, with the same constants
and structure (Grassi-Khovratovich-Schofnegger, the in-circuit hasher of
the reference's Poseidon2Gate):

* the external matrix M_E applied to the input state,
* 4 external rounds: add a round constant to every lane, x^7 on every
  lane, M_E,
* 22 internal rounds: add a round constant to lane 0, x^7 on lane 0 only,
  the internal matrix M_I,
* 4 external rounds.

M_E = kron(J3 + I3, M4) with the M4 circulant block
[[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]]; M_I = diag(mu) + J12.  Both are
dense 12x12 matrices.  The constants come from the SHA-256 counter-mode
generator tagged "plonky2_tpu/poseidon2/rc/v1" (hashes/poseidon.py
`_prg_field_elems`).  The sponge (overwrite mode, RATE 8) is the one of
hashes/poseidon.py.

The JAX package's batched forms are XLA, not Pallas kernels, so the
port's are plain torch on every device: `permute_cols` on lanes-first
states [12, B], `permute` and `hash_no_pad` on rows [..., 12].
"""

from __future__ import annotations

import functools

import torch

from ..field import gl
from .poseidon import _prg_field_elems, sbox

WIDTH = 12
RATE = 8
HASH_OUT = 4
EXTERNAL_ROUNDS = 8      # 4 + 4
INTERNAL_ROUNDS = 22
ALPHA = 7

_M4 = [[5, 7, 1, 3],
       [4, 6, 1, 1],
       [1, 3, 5, 7],
       [1, 1, 4, 6]]


def _external_matrix() -> list[list[int]]:
    """kron(J3 + I3, M4): M4 within each 4-lane chunk, twice on the
    diagonal blocks."""
    me = [[0] * WIDTH for _ in range(WIDTH)]
    for bi in range(3):
        for bj in range(3):
            coeff = 2 if bi == bj else 1
            for i in range(4):
                for j in range(4):
                    me[4 * bi + i][4 * bj + j] = coeff * _M4[i][j] % gl.P
    return me


def _internal_matrix(diag: list[int]) -> list[list[int]]:
    mi = [[1] * WIDTH for _ in range(WIDTH)]
    for i in range(WIDTH):
        mi[i][i] = (1 + diag[i]) % gl.P
    return mi


def _constants():
    """(external round constants [8][12], internal ones [22], the
    internal diagonal [12]), in the generator's order."""
    flat = _prg_field_elems("plonky2_tpu/poseidon2/rc/v1",
                            EXTERNAL_ROUNDS * WIDTH + INTERNAL_ROUNDS + WIDTH)
    ext_rcs = [flat[r * WIDTH:(r + 1) * WIDTH] for r in range(EXTERNAL_ROUNDS)]
    rest = flat[EXTERNAL_ROUNDS * WIDTH:]
    return ext_rcs, rest[:INTERNAL_ROUNDS], rest[INTERNAL_ROUNDS:]


EXTERNAL_RCS, INTERNAL_RCS, INTERNAL_DIAG = _constants()
M_E = _external_matrix()
M_I = _internal_matrix(INTERNAL_DIAG)


@functools.lru_cache(maxsize=None)
def tensors(device) -> dict:
    """M_E and M_I [12, 12], the external round constants [8, 12] and the
    internal ones [22], on `device`."""
    return {"me": gl.to_tensor(M_E, device), "mi": gl.to_tensor(M_I, device),
            "erc": gl.to_tensor(EXTERNAL_RCS, device),
            "irc": gl.to_tensor(INTERNAL_RCS, device)}


# ------------------------------------------------------------------
# scalar permutation
# ------------------------------------------------------------------

def _sbox_s(x: int) -> int:
    x3 = x * x % gl.P * x % gl.P
    return x3 * x3 % gl.P * x % gl.P


def _matmul_s(m, state):
    return [sum(m[i][j] * state[j] for j in range(WIDTH)) % gl.P
            for i in range(WIDTH)]


def permute_s(state: list[int]) -> list[int]:
    if len(state) != WIDTH:
        raise ValueError(f"state has {len(state)} elements, want {WIDTH}")
    s = _matmul_s(M_E, state)
    for r in range(EXTERNAL_ROUNDS // 2):
        s = [_sbox_s((x + c) % gl.P) for x, c in zip(s, EXTERNAL_RCS[r])]
        s = _matmul_s(M_E, s)
    for r in range(INTERNAL_ROUNDS):
        s[0] = _sbox_s((s[0] + INTERNAL_RCS[r]) % gl.P)
        s = _matmul_s(M_I, s)
    for r in range(EXTERNAL_ROUNDS // 2, EXTERNAL_ROUNDS):
        s = [_sbox_s((x + c) % gl.P) for x, c in zip(s, EXTERNAL_RCS[r])]
        s = _matmul_s(M_E, s)
    return s


# ------------------------------------------------------------------
# batched permutation, plain torch
# ------------------------------------------------------------------

def matmul_cols(m, s):
    """m [12, 12] (a tensor on s's device), s [12, N] -> m . s [12, N]."""
    return gl.sum_mod(gl.mul(m[:, :, None], s[None, :, :]), dim=1)


def permute_cols(s):
    """Lanes-first states [12, B] -> [12, B]."""
    t = tensors(s.device)
    me, mi, erc, irc = t["me"], t["mi"], t["erc"], t["irc"]
    s = matmul_cols(me, s)
    for r in range(EXTERNAL_ROUNDS // 2):
        s = matmul_cols(me, sbox(gl.add(s, erc[r][:, None])))
    for r in range(INTERNAL_ROUNDS):
        lane0 = sbox(gl.add(s[0], irc[r].expand_as(s[0])))
        s = matmul_cols(mi, torch.cat([lane0[None], s[1:]], dim=0))
    for r in range(EXTERNAL_ROUNDS // 2, EXTERNAL_ROUNDS):
        s = matmul_cols(me, sbox(gl.add(s, erc[r][:, None])))
    return s


def permute(states):
    """Row states [..., 12] -> [..., 12]."""
    flat = states.reshape(-1, WIDTH).T
    return permute_cols(flat).T.reshape(states.shape)


# ------------------------------------------------------------------
# sponge (the semantics of hashes/poseidon.py)
# ------------------------------------------------------------------

def hash_n_to_m_no_pad_s(inputs: list[int], num_outputs: int = HASH_OUT) -> list[int]:
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i:i + RATE]
        state[:len(chunk)] = chunk
        state = permute_s(state)
    outputs: list[int] = []
    while True:
        outputs.extend(state[:RATE])
        if len(outputs) >= num_outputs:
            return outputs[:num_outputs]
        state = permute_s(state)


def hash_no_pad_s(inputs: list[int]) -> list[int]:
    return hash_n_to_m_no_pad_s(inputs, HASH_OUT)


def pad_inputs(inputs: list[int]) -> list[int]:
    padded = list(inputs) + [1]
    while (len(padded) + 1) % WIDTH:
        padded.append(0)
    return padded + [1]


def hash_pad_s(inputs: list[int]) -> list[int]:
    return hash_no_pad_s(pad_inputs(inputs))


def two_to_one_s(x: list[int], y: list[int]) -> list[int]:
    if len(x) != HASH_OUT or len(y) != HASH_OUT:
        raise ValueError("two_to_one takes two 4-element digests")
    return permute_s(list(x) + list(y) + [0] * (WIDTH - 2 * HASH_OUT))[:HASH_OUT]


def hash_or_noop_s(inputs: list[int]) -> list[int]:
    if len(inputs) <= HASH_OUT:
        return list(inputs) + [0] * (HASH_OUT - len(inputs))
    return hash_no_pad_s(inputs)


def hash_no_pad(inputs, num_outputs: int = HASH_OUT):
    """Rows: inputs [L, C] -> [L, num_outputs]."""
    L, C = inputs.shape
    state = torch.zeros((L, WIDTH), dtype=gl.DTYPE, device=inputs.device)
    for i in range(0, C, RATE):
        chunk = inputs[:, i:i + RATE]
        state = permute(torch.cat([chunk, state[:, chunk.shape[1]:]], dim=1))
    outs = [state[:, :RATE]]
    have = RATE
    while have < num_outputs:
        state = permute(state)
        outs.append(state[:, :RATE])
        have += RATE
    return torch.cat(outs, dim=1)[:, :num_outputs]
