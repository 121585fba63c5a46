"""Radix-2 NTT / inverse NTT / coset LDE over Goldilocks, on torch tensors.

Counterpart of `plonky2_tpu/ntt/ntt.py`.  Every butterfly stage is one
reshape plus elementwise field ops over the whole (batched) tensor;
[num_polys, n] is the common layout.

Conventions:
* `ntt(coeffs)[..., i] = poly(w^i)`, w the primitive n-th root, natural order.
* `coset_lde(coeffs, rate_bits, shift)` evaluates on shift * <w_{n*2^rate}>
  in natural order; the `_rev` variants store the same values in
  BIT-REVERSED domain order (plonky2's storage layout, see fri/fri.py).

`lde_from_values_rev_auto` is the prover's commit-path dispatcher: for a
CUDA tensor kernel K2 (`cuda_lde`, n <= 2^13) or K3 (`cuda_lde_tiled`,
2^14 <= n <= 2^20), for a CPU tensor the plain version.
`lde_from_values_auto` is the same for the natural-order LDE (K2-nat).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import gl

# plonky2 evaluates LDEs on cosets shifted by the multiplicative group
# generator g = 7 ("standard coset").
COSET_SHIFT = gl.GENERATOR

host_powers = gl.host_powers


@functools.lru_cache(maxsize=None)
def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def bitrev_index(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_perm(log_n)).to(device)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool, device) -> tuple:
    """Per-stage twiddles: the stage with half-size m gets [w_{2m}^k]_{k<m}."""
    out = []
    for s in range(1, log_n + 1):
        root = gl.primitive_root_of_unity(s)
        if inverse:
            root = gl.inv_s(root)
        out.append(gl.powers(root, 1 << (s - 1), device))
    return tuple(out)


def _const(c: int, like: torch.Tensor) -> torch.Tensor:
    return gl.full((), c, like.device)


def ntt(coeffs, inverse: bool = False):
    """[..., n] coefficients -> evaluations (or inverse, unscaled)."""
    n = coeffs.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of 2, got {n}")
    if n == 1:
        return coeffs
    batch = coeffs.shape[:-1]
    x = coeffs.index_select(-1, bitrev_index(log_n, coeffs.device))
    return _dit_stages(x, _stage_twiddles(log_n, inverse, coeffs.device), batch, n)


def _dit_stages(x, tw, batch, n):
    log_n = n.bit_length() - 1
    for s in range(1, log_n + 1):
        m = 1 << (s - 1)
        x = x.reshape(*batch, n >> s, 2, m)
        even = x[..., 0, :]
        odd = gl.mul(x[..., 1, :], tw[s - 1])
        x = torch.stack([gl.add(even, odd), gl.sub(even, odd)], dim=-2)
    return x.reshape(*batch, n)


def intt(evals):
    """Inverse NTT: evaluations (natural order) -> coefficients."""
    n = evals.shape[-1]
    coeffs = ntt(evals, inverse=True)
    return gl.mul(coeffs, _const(gl.inv_s(n), coeffs))


def ntt_to_rev(coeffs, inverse: bool = False):
    """Natural-order coefficients -> BIT-REVERSED evaluations, by
    decimation-in-frequency stages (no permutation pass)."""
    n = coeffs.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of 2, got {n}")
    if n == 1:
        return coeffs
    batch = coeffs.shape[:-1]
    x = coeffs
    tw = _stage_twiddles(log_n, inverse, coeffs.device)
    # DIF: half-sizes n/2 .. 1; butterfly (e, o) -> (e + o, (e - o) * w^t)
    for s in range(log_n, 0, -1):
        m = 1 << (s - 1)
        x = x.reshape(*batch, n >> s, 2, m)
        e = x[..., 0, :]
        o = x[..., 1, :]
        x = torch.stack([gl.add(e, o), gl.mul(gl.sub(e, o), tw[s - 1])], dim=-2)
    return x.reshape(*batch, n)


def intt_from_rev(evals_rev):
    """BIT-REVERSED evaluations -> natural-order coefficients: the DIT
    stage chain of `ntt` without its input gather, scaled by 1/n."""
    n = evals_rev.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of 2, got {n}")
    if n == 1:
        return evals_rev
    x = _dit_stages(evals_rev, _stage_twiddles(log_n, True, evals_rev.device),
                    evals_rev.shape[:-1], n)
    return gl.mul(x, _const(gl.inv_s(n), x))


@functools.lru_cache(maxsize=None)
def _shift_powers(shift: int, n: int, device) -> torch.Tensor:
    return gl.powers(shift, n, device)


def _scaled_padded(coeffs, rate_bits: int, shift: int):
    n = coeffs.shape[-1]
    scaled = gl.mul(coeffs, _shift_powers(shift, n, coeffs.device))
    pad = torch.zeros((*coeffs.shape[:-1], (n << rate_bits) - n),
                      dtype=gl.DTYPE, device=coeffs.device)
    return torch.cat([scaled, pad], dim=-1)


def coset_lde(coeffs, rate_bits: int, shift: int = COSET_SHIFT):
    """Evaluate deg<n polys on the coset shift*<w_N>, N = n << rate_bits:
    [..., n] coeffs -> [..., N] values in natural order."""
    return ntt(_scaled_padded(coeffs, rate_bits, shift))


def coset_lde_rev(coeffs, rate_bits: int, shift: int = COSET_SHIFT):
    """Like `coset_lde` but the [..., N] output is in BIT-REVERSED domain
    order: position r holds poly(shift * w^rev(r))."""
    return ntt_to_rev(_scaled_padded(coeffs, rate_bits, shift))


def lde_from_values(values, rate_bits: int, shift: int = COSET_SHIFT):
    """Values over H (natural order) -> (coeffs, LDE over the coset, both in
    natural order).  The plain version of kernel K2-nat."""
    coeffs = intt(values)
    return coeffs, coset_lde(coeffs, rate_bits, shift)


def lde_from_values_rev(values, rate_bits: int, shift: int = COSET_SHIFT):
    """Values over H (natural order) -> (coeffs natural order, LDE in
    bit-reversed order).  The plain version of kernels K2-rev and K3."""
    coeffs = intt(values)
    return coeffs, coset_lde_rev(coeffs, rate_bits, shift)


def lde_from_values_auto(values, rate_bits: int, shift: int = COSET_SHIFT):
    """Values over H -> (coeffs natural, LDE natural), plain torch."""
    return lde_from_values(values, rate_bits, shift)


def lde_from_values_rev_auto(values, rate_bits: int, shift: int = COSET_SHIFT):
    """Values over H -> (coeffs natural, LDE bit-reversed), plain torch."""
    return lde_from_values_rev(values, rate_bits, shift)


def eval_polys_at_ext(coeffs, point):
    """Evaluate base-field polys [..., n] at one extension point (c0, c1).

    Returns [..., 2]: one broadcast multiply by the point's powers, then a
    modular tree sum over the coefficient axis."""
    from ..field import ext
    n = coeffs.shape[-1]
    pows = ext.powers_s(point, n, coeffs.device)           # [n, 2]
    prod = ext.mul_base(pows, coeffs)                      # [..., n, 2]
    return gl.sum_mod(prod, dim=-2)
