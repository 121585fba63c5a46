"""Kernel K3: values -> (coefficients, bit-reversed coset LDE) on the card
for 2^14 <= n <= 2^20, as a four-step transform n = n1 * n2
(`csrc/lde_tiled.cu`).

Replaces `plonky2_tpu/ntt/pallas_lde_tiled.py` `lde_from_values_tiled_rev`.
`ntt.lde_from_values_rev_auto` sends a CUDA tensor of that size here; the
plain version is `ntt.lde_from_values_rev`, which the dispatcher runs for a
CPU tensor.  For a CUDA tensor outside the kernel's range the wrapper
raises.  There is no probe and no fallback.

The host tables follow the JAX kernel's four-step identity: the inter-pass
twiddle `inter_twiddle` and the coset-scale factors `scale_vectors` equal
`_inter_twiddle` and `_scale_vectors` of `pallas_lde_tiled.py` for the same
(log n, log n1).  The kernel reads two tables derived from them:
`inverse_twiddle` (1/n folded into pass A's twiddle) and `coset_twiddle`
(the coset scale's column-constant factor folded into pass C's).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..field import gl
from .cuda_lde import MAX_RATE_BITS, run_lde
from .ntt import COSET_SHIFT, _bitrev_perm

LAUNCHES = 0                 # kernel launches made by `lde_from_values_tiled_rev_cuda`
MIN_LOG_N = 14
MAX_LOG_N = 20


def supported(n: int, rate_bits: int) -> bool:
    return (1 << MIN_LOG_N) <= n <= (1 << MAX_LOG_N) and n & (n - 1) == 0 \
        and 0 <= rate_bits <= MAX_RATE_BITS


def split_log(log_n: int) -> tuple[int, int]:
    """(log n1, log n2) of the kernel's [n1, n2] view: n1 = 2^(log_n // 2)."""
    log_n1 = log_n // 2
    return log_n1, log_n - log_n1


@functools.lru_cache(maxsize=None)
def inter_twiddle(log_n: int, log_n1: int, sign: int) -> np.ndarray:
    """[n1, n2] uint64: row j1 holds w_n^(sign * rev_n1(j1) * i2), i2 < n2."""
    n1, n2 = 1 << log_n1, 1 << (log_n - log_n1)
    w = gl.primitive_root_of_unity(log_n)
    if sign < 0:
        w = gl.inv_s(w)
    rev = _bitrev_perm(log_n1)
    return np.stack([gl.host_powers(pow(w, int(rev[j1]), gl.P), n2)
                     for j1 in range(n1)])


def scale_vectors(log_n: int, log_n1: int, rate_bits: int, shift: int):
    """(u [2^rate, n1], v [2^rate, n2]) uint64 with u[kk][j1] * v[kk][j2] =
    s_k^(j1 * n2 + j2), s_k = shift * w_N^rev_rate(kk): coset block kk holds
    coset k = rev_rate(kk), so the blocks stack in the big domain's
    bit-reversed order."""
    n1, n2 = 1 << log_n1, 1 << (log_n - log_n1)
    rev_r = _bitrev_perm(rate_bits)
    w_big = gl.primitive_root_of_unity(log_n + rate_bits)
    u, v = [], []
    for kk in range(1 << rate_bits):
        s_k = shift * pow(w_big, int(rev_r[kk]), gl.P) % gl.P
        v.append(gl.host_powers(s_k, n2))
        u.append(gl.host_powers(pow(s_k, n2, gl.P), n1))
    return np.stack(u), np.stack(v)


def inverse_twiddle(log_n: int, log_n1: int, device="cpu") -> torch.Tensor:
    """[n1, n2]: pass A's factor after the column transform, w_n^(-rev_n1(j1)
    * i2) / n at (j1, i2) (the inverse transform's 1/n folded in)."""
    t = gl.to_tensor(inter_twiddle(log_n, log_n1, -1), device)
    return gl.mul(t, gl.full((), gl.inv_s(1 << log_n), device))


def coset_twiddle(log_n: int, log_n1: int, rate_bits: int, shift: int,
                  device="cpu") -> torch.Tensor:
    """[2^rate, n1, n2]: pass C's factor after the column transform of coset
    block kk, v[kk][j2] * w_n^(rev_n1(r1) * j2) at (kk, r1, j2).  The coset
    scale's factor v is constant down a column, so it commutes with the
    column transform and joins the four-step twiddle; the factor u[kk][j1]
    is applied before the transform.  It holds 2^rate * n words, 1/batch of
    the LDE it serves (64 MB at n = 2^20, rate 3), kept on the card by
    `_tables` for each (log n, rate, shift)."""
    _, v = scale_vectors(log_n, log_n1, rate_bits, shift)
    t = gl.to_tensor(inter_twiddle(log_n, log_n1, +1), device)
    return gl.mul(gl.to_tensor(v, device)[:, None, :], t[None])


@functools.lru_cache(maxsize=None)
def _tables(log_n: int, rate_bits: int, shift: int, device):
    """Device tables of one (log n, rate, shift), in the C interface's
    order: the column and row twiddles [n1/2], [n2/2] (inverse and
    forward), `inverse_twiddle`, `coset_twiddle` and the scale u [2^rate,
    n1]."""
    log_n1, log_n2 = split_log(log_n)
    out = []
    for log_len in (log_n1, log_n2):
        w = gl.primitive_root_of_unity(log_len)
        out.append(gl.to_tensor(gl.host_powers(gl.inv_s(w), 1 << (log_len - 1)), device))
        out.append(gl.to_tensor(gl.host_powers(w, 1 << (log_len - 1)), device))
    out.append(inverse_twiddle(log_n, log_n1, device))
    out.append(coset_twiddle(log_n, log_n1, rate_bits, shift, device))
    out.append(gl.to_tensor(scale_vectors(log_n, log_n1, rate_bits, shift)[0], device))
    return tuple(out)


def lde_from_values_tiled_rev_cuda(values: torch.Tensor, rate_bits: int,
                                   shift: int = COSET_SHIFT):
    """Launch K3 on values [..., n] int64 on a CUDA device -> (coeffs
    natural, LDE bit-reversed)."""
    global LAUNCHES

    def launch(v, coeffs, lde, b, log_n, stream):
        log_n1, log_n2 = split_log(log_n)
        tables = _tables(log_n, rate_bits, shift % gl.P, values.device)
        scratch = torch.empty((b, 1 << log_n), dtype=gl.DTYPE, device=values.device)
        return _build.lib().p2t_lde_tiled_rev(
            v.data_ptr(), coeffs.data_ptr(), lde.data_ptr(), scratch.data_ptr(),
            *(t.data_ptr() for t in tables), b, log_n1, log_n2, rate_bits, stream)
    coeffs, lde, launched = run_lde(
        "K3", values, rate_bits, supported, f"2^{MIN_LOG_N} <= n <= 2^{MAX_LOG_N}", launch)
    LAUNCHES += launched
    return coeffs, lde


def geometry(log_l: int) -> dict:
    """The built kernel's own geometry for a transform of 2^log_l points:
    {"threads" a block, "log_tile" of passes A, B and D, "log_tile_c" of
    pass C, "groups": the stages of each register group, top bits first}."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.lib().p2t_lde_tiled_geometry(log_l, out), f"K3 geometry of 2^{log_l}")
    return {"threads": out[0], "log_tile": out[1], "log_tile_c": out[2],
            "groups": tuple(k for k in out[3:] if k)}
