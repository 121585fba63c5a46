"""Kernel K2: values -> (coefficients, coset LDE) on the card (`csrc/lde.cu`).

Replaces `plonky2_tpu/ntt/pallas_lde.py` `lde_from_values_pallas_rev`
(K2-rev: the LDE in bit-reversed order, the commit path) and
`lde_from_values_pallas` (K2-nat: the LDE in natural order).  The
dispatchers `ntt.lde_from_values_rev_auto` and `ntt.lde_from_values_auto`
send a CUDA tensor here and run the plain torch versions
(`ntt.lde_from_values_rev`, `ntt.lde_from_values`) for a CPU tensor.  The
kernel takes 2 <= n <= 2^13 and 2^rate <= 64; for a CUDA tensor outside
that range the wrapper raises (2^14 <= n <= 2^20 is the tiled kernel K3,
`cuda_lde_tiled`).  There is no probe and no fallback.

For 2^11 <= n <= 2^13 a call is two launches: the inverse transform once a
polynomial into `coeffs`, then one block a (polynomial, coset) that reads
the coefficients back and runs the coset's forward transform, both in
register groups (`geometry`).  Below 2^11 it is one launch of the first
design's body.  Either way a call adds one to its counter.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..field import gl
from .ntt import COSET_SHIFT

LAUNCHES = 0                 # K2-rev calls that launched, `lde_from_values_rev_cuda`
LAUNCHES_NAT = 0             # K2-nat calls that launched, `lde_from_values_cuda`
MAX_LOG_N = 13
MAX_RATE_BITS = 6


def supported(n: int, rate_bits: int) -> bool:
    return 2 <= n <= (1 << MAX_LOG_N) and n & (n - 1) == 0 \
        and 0 <= rate_bits <= MAX_RATE_BITS


@functools.lru_cache(maxsize=None)
def _tables(log_n: int, rate_bits: int, shift: int, device):
    """(tw_inv [n/2], tw_fwd [n/2], coset_pows [2^rate, n]) on `device`:
    tw[t] = w_n^(+-t); coset_pows[k][j] = (shift * w_N^k)^j."""
    n = 1 << log_n
    w = gl.primitive_root_of_unity(log_n)
    tw_fwd = gl.host_powers(w, n // 2)
    tw_inv = gl.host_powers(gl.inv_s(w), n // 2)
    w_big = gl.primitive_root_of_unity(log_n + rate_bits)
    pows = np.stack([gl.host_powers(shift * pow(w_big, k, gl.P) % gl.P, n)
                     for k in range(1 << rate_bits)])
    return (gl.to_tensor(tw_inv, device), gl.to_tensor(tw_fwd, device),
            gl.to_tensor(pows, device))


def run_lde(tag: str, values: torch.Tensor, rate_bits: int, supported, range_text: str,
            launch):
    """What the LDE kernels' wrappers (K2, K3) share.  Checks that values
    [..., n] are int64 on a CUDA device and that supported(n, rate_bits)
    holds, views them as [b, n], allocates coeffs [b, n] and the LDE
    [b, n * 2^rate_bits], and unless b == 0 calls launch(v, coeffs, lde, b,
    log_n, stream), which returns the C interface's status.  -> (coeffs,
    lde, launched)."""
    n = values.shape[-1]
    if values.dtype != gl.DTYPE:
        raise ValueError(f"{tag} takes int64 values, got {values.dtype}")
    if values.device.type != "cuda":
        raise ValueError(f"{tag} takes a CUDA tensor, got one on {values.device}")
    if not supported(n, rate_bits):
        raise ValueError(
            f"{tag} takes {range_text}, n a power of 2, and rate_bits <= "
            f"{MAX_RATE_BITS}, got n={n}, rate_bits={rate_bits}")
    batch = values.shape[:-1]
    b = int(np.prod(batch)) if batch else 1
    v = values.reshape(b, n).contiguous()
    coeffs = torch.empty((b, n), dtype=gl.DTYPE, device=values.device)
    lde = torch.empty((b, n << rate_bits), dtype=gl.DTYPE, device=values.device)
    if b:
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            _build.check(launch(v, coeffs, lde, b, n.bit_length() - 1, stream),
                         f"{tag} launch")
    return coeffs.reshape(*batch, n), lde.reshape(*batch, n << rate_bits), b > 0


def _launch(values: torch.Tensor, rate_bits: int, shift: int, natural: bool):
    def launch(v, coeffs, lde, b, log_n, stream):
        tw_inv, tw_fwd, pows = _tables(log_n, rate_bits, shift % gl.P, values.device)
        return _build.lib().p2t_lde_from_values(
            v.data_ptr(), coeffs.data_ptr(), lde.data_ptr(), tw_inv.data_ptr(),
            tw_fwd.data_ptr(), pows.data_ptr(), b, log_n, rate_bits, gl.inv_s(1 << log_n),
            int(natural), stream)
    return run_lde("K2", values, rate_bits, supported, f"2 <= n <= 2^{MAX_LOG_N}", launch)


def lde_from_values_rev_cuda(values: torch.Tensor, rate_bits: int,
                             shift: int = COSET_SHIFT):
    """K2-rev on values [..., n] int64 on a CUDA device -> (coeffs natural,
    LDE bit-reversed)."""
    global LAUNCHES
    coeffs, lde, launched = _launch(values, rate_bits, shift, natural=False)
    LAUNCHES += launched
    return coeffs, lde


def lde_from_values_cuda(values: torch.Tensor, rate_bits: int,
                         shift: int = COSET_SHIFT):
    """K2-nat on values [..., n] int64 on a CUDA device -> (coeffs natural,
    LDE natural: position t holds the value at shift * w_N^t)."""
    global LAUNCHES_NAT
    coeffs, lde, launched = _launch(values, rate_bits, shift, natural=True)
    LAUNCHES_NAT += launched
    return coeffs, lde


def geometry(log_n: int) -> dict:
    """The built kernel's own geometry for n = 2^log_n, 2^11 <= n <= 2^13:
    {"threads" a block, "groups": the stages of each register group, top
    bits first}."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.lib().p2t_lde_geometry(log_n, out), f"K2 geometry of 2^{log_n}")
    return {"threads": out[0], "groups": tuple(k for k in out[1:] if k)}
