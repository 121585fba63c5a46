"""Poseidon permutation + sponge over Goldilocks, width 12.

Counterpart of `plonky2_tpu/hashes/poseidon.py`, with the same constants:
t = 12, RATE = 8, alpha = 7, 4 + 22 + 4 rounds, round constants from the
SHA-256 counter-mode generator tagged "plonky2_tpu/poseidon/rc/v1", and
plonky2's small-entry circulant MDS — unless the JAX package's directory
holds `poseidon_constants.json`, whose tables then take their place in
both packages.

Two implementations, tested against each other:
* scalar (Python ints) for the host transcript, witness and verifier;
* lanes-first tensors [12, B] for the device Merkle trees and PoW grind.
  `permute_cols` is the entry point: on a CUDA tensor it launches the
  hand-written kernel (`cuda_poseidon`), on a CPU tensor it runs
  `permute_cols_plain`, the torch version below.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os

import torch

from ..field import gl

WIDTH = 12
RATE = 8
FULL_ROUNDS = 8          # 4 + 4
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
ALPHA = 7
HASH_OUT = 4             # elements per digest ("HashOut")

# Where the JAX package looks for injected constant tables.
_CONSTANTS_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "plonky2_tpu", "hashes", "poseidon_constants.json")


# ------------------------------------------------------------------
# Constants
# ------------------------------------------------------------------

def _prg_field_elems(tag: str, n: int) -> list[int]:
    """n field elements < p from SHA-256(tag || counter), rejection-sampled."""
    out: list[int] = []
    ctr = 0
    while len(out) < n:
        h = hashlib.sha256(f"{tag}/{ctr}".encode()).digest()
        ctr += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off:off + 8], "little")
            if v < gl.P and len(out) < n:
                out.append(v)
    return out


# plonky2's Goldilocks-Poseidon MDS: row r is the circulant shift
# M[r][j] = CIRC[(j - r) mod 12], plus DIAG[r] on the diagonal.
MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8] + [0] * 11


def _circulant_mds() -> list[list[int]]:
    return [[MDS_CIRC[(j - i) % WIDTH] + (MDS_DIAG[i] if i == j else 0)
             for j in range(WIDTH)] for i in range(WIDTH)]


def _load_constants():
    if os.path.exists(_CONSTANTS_JSON):
        with open(_CONSTANTS_JSON) as f:
            data = json.load(f)
        rc = [[int(x) for x in row] for row in data["round_constants"]]
        mds = [[int(x) for x in row] for row in data["mds"]]
        if len(rc) != N_ROUNDS or any(len(r) != WIDTH for r in rc):
            raise ValueError(f"{_CONSTANTS_JSON}: round_constants must be "
                             f"[{N_ROUNDS}][{WIDTH}]")
        if len(mds) != WIDTH or any(len(r) != WIDTH for r in mds):
            raise ValueError(f"{_CONSTANTS_JSON}: mds must be [{WIDTH}][{WIDTH}]")
        return rc, mds
    flat = _prg_field_elems("plonky2_tpu/poseidon/rc/v1", N_ROUNDS * WIDTH)
    rc = [flat[r * WIDTH:(r + 1) * WIDTH] for r in range(N_ROUNDS)]
    return rc, _circulant_mds()


ROUND_CONSTANTS, MDS = _load_constants()

# MDS layer split: with every entry < 2^20, each output row is 12 exact
# int64 products per 32-bit input half, reduced once (sum < 2^56).  A
# large-entry matrix takes full Goldilocks multiplies instead.
MDS_SMALL = max(max(row) for row in MDS) < (1 << 20)


def _mat_inv(m: list[list[int]]) -> list[list[int]]:
    """Inverse of a square matrix over the field (Gauss-Jordan)."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for c in range(n):
        piv = next(r for r in range(c, n) if a[r][c])
        a[c], a[piv] = a[piv], a[c]
        inv = pow(a[c][c], gl.P - 2, gl.P)
        a[c] = [x * inv % gl.P for x in a[c]]
        for r in range(n):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(x - f * y) % gl.P for x, y in zip(a[r], a[c])]
    return [row[n:] for row in a]


def _mat_mul(a, b) -> list[list[int]]:
    return [[sum(x * y for x, y in zip(row, col)) % gl.P for col in zip(*b)] for row in a]


def _mat_vec(m, x) -> list[int]:
    return [sum(a * b for a, b in zip(row, x)) % gl.P for row in m]


@functools.lru_cache(maxsize=None)
def _fast_partial_tables(rc: tuple, mds: tuple) -> dict:
    m_inv = _mat_inv(mds)
    c = [list(row) for row in rc]
    lo, hi = FULL_ROUNDS // 2, FULL_ROUNDS // 2 + PARTIAL_ROUNDS - 1
    post = [0] * PARTIAL_ROUNDS
    for r in range(hi, lo, -1):
        u = _mat_vec(m_inv, c[r])
        c[r - 1] = [c[r - 1][0]] + [(x + y) % gl.P for x, y in zip(c[r - 1][1:], u[1:])]
        post[r - lo - 1] = u[0]
    m00, v, w = [0] * PARTIAL_ROUNDS, [None] * PARTIAL_ROUNDS, [None] * PARTIAL_ROUNDS
    x = [list(row) for row in mds]
    for i in range(PARTIAL_ROUNDS - 1, -1, -1):
        x_hat = [row[1:] for row in x[1:]]
        m00[i] = x[0][0]
        v[i] = _mat_mul([x[0][1:]], _mat_inv(x_hat))[0]
        w[i] = [row[0] for row in x[1:]]
        x = [list(mds[0])] + _mat_mul(x_hat, mds[1:])          # diag(1, x_hat) . mds
    return {"first": c[lo], "initial": x_hat, "post": post, "m00": m00, "v": v, "w": w}


def fast_partial_tables(round_constants, mds) -> dict:
    """Tables of plonky2's fast partial rounds for these constants and this
    MDS matrix (any MDS matrix: every square submatrix is invertible), as
    Python ints.  A round is s <- M . sbox(s + c_r) on column vectors; the
    partial rounds 4 .. 25 become:

      s += first                       (all 12 lanes)
      s[1:] = initial . s[1:]          (11 x 11)
      for i in 0 .. 21:
          s0 = sbox(s0) + post[i]
          s0, s[1:] = m00[i] s0 + v[i] . s[1:],  s[1:] + w[i] s0

    Each c_r (r = 25 .. 5) is pushed back through M: u = M^-1 c_r adds
    u[1:] to c_{r-1} and leaves u[0] as post[r - 5] (post[21] = 0), so
    first is the resulting c_4.  Going back from the last round, X = M
    factors as S_i . diag(1, X^) with X^ = X[1:, 1:], S_i = [[m00, v], [w,
    I]]; the diag(1, X^) part commutes with the next S-box (lane 0 only) and
    joins the round before: X <- diag(1, X^) . M.  The last X^ is `initial`.
    Keys: "first" [12], "initial" [11][11], "post", "m00" [22], "v", "w"
    [22][11]."""
    return _fast_partial_tables(tuple(map(tuple, round_constants)),
                                tuple(map(tuple, mds)))


@functools.lru_cache(maxsize=None)
def rc_tensor(device) -> torch.Tensor:
    return gl.to_tensor(ROUND_CONSTANTS, device)          # [30, 12]


@functools.lru_cache(maxsize=None)
def mds_tensor(device) -> torch.Tensor:
    return gl.to_tensor(MDS, device)                      # [12, 12]


# ------------------------------------------------------------------
# Scalar permutation (Python ints)
# ------------------------------------------------------------------

def _sbox_s(x: int) -> int:
    x2 = (x * x) % gl.P
    x3 = (x2 * x) % gl.P
    return (x3 * x3 % gl.P) * x % gl.P


def _mds_s(state: list[int]) -> list[int]:
    return [sum(MDS[i][j] * state[j] for j in range(WIDTH)) % gl.P
            for i in range(WIDTH)]


def permute_s(state: list[int]) -> list[int]:
    """Scalar Poseidon permutation on 12 Python ints."""
    if len(state) != WIDTH:
        raise ValueError(f"state has {len(state)} elements, want {WIDTH}")
    s = list(state)
    r = 0
    for _ in range(FULL_ROUNDS // 2):
        s = [(x + c) % gl.P for x, c in zip(s, ROUND_CONSTANTS[r])]
        s = _mds_s([_sbox_s(x) for x in s])
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        s = [(x + c) % gl.P for x, c in zip(s, ROUND_CONSTANTS[r])]
        s[0] = _sbox_s(s[0])
        s = _mds_s(s)
        r += 1
    for _ in range(FULL_ROUNDS // 2):
        s = [(x + c) % gl.P for x, c in zip(s, ROUND_CONSTANTS[r])]
        s = _mds_s([_sbox_s(x) for x in s])
        r += 1
    return s


# ------------------------------------------------------------------
# Lanes-first tensor permutation: states [12, B]
# ------------------------------------------------------------------

def sbox(x):
    x3 = gl.mul(gl.sqr(x), x)
    return gl.mul(gl.sqr(x3), x)


def _mds_reduce_small(acc_lo, acc_hi):
    """Reduce acc_lo + acc_hi*2^32 (both < 2^56) mod p, to canonical form."""
    hi1 = acc_hi >> 32                            # < 2^24 (acc_hi >= 0)
    hi0 = acc_hi & gl.MASK32
    d = acc_lo + hi1 * gl.EPSILON                 # < 2^57: no wrap
    t = d + (hi0 << 32)                           # may wrap once
    t = t + gl.ult(t, d).to(gl.DTYPE) * gl.EPSILON
    return gl._canon(t)


def mds_cols(s):
    """MDS layer on lanes-first states [12, ...]."""
    mds = mds_tensor(s.device).reshape((WIDTH, WIDTH) + (1,) * (s.dim() - 1))
    if MDS_SMALL:
        s_lo = (s & gl.MASK32)[None]
        s_hi = gl._shr32(s)[None]
        return _mds_reduce_small((s_lo * mds).sum(dim=1),
                                 (s_hi * mds).sum(dim=1))
    prod = gl.mul(mds, s[None].expand((WIDTH,) + s.shape))
    return gl.sum_mod(prod, dim=1)


def permute_cols_plain(s):
    """Poseidon permutation, plain torch: s [12, B] -> [12, B]."""
    rc = rc_tensor(s.device)
    r = 0
    for _ in range(FULL_ROUNDS // 2):
        s = mds_cols(sbox(gl.add(s, rc[r][:, None])))
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        s = gl.add(s, rc[r][:, None])
        s = mds_cols(torch.cat([sbox(s[:1]), s[1:]], dim=0))
        r += 1
    for _ in range(FULL_ROUNDS // 2):
        s = mds_cols(sbox(gl.add(s, rc[r][:, None])))
        r += 1
    return s


def permute_cols(s):
    """Poseidon permutation in lanes-first layout: s [12, B] -> [12, B],
    plain torch on every device."""
    return permute_cols_plain(s)


# ------------------------------------------------------------------
# Sponge — scalar
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


def pad_inputs(inputs: list[int]) -> list[int]:
    """10*1 padding: append 1, then zeros, then a final 1 that ends the
    input at a multiple of WIDTH."""
    padded = list(inputs) + [1]
    while (len(padded) + 1) % WIDTH != 0:
        padded.append(0)
    padded.append(1)
    return padded


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


# ------------------------------------------------------------------
# Sponge — lanes-first ("cols") layout: [C, B] inputs, [4, B] digests.
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
