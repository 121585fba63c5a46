"""Quadratic extension GF(p^2) = F_p[X] / (X^2 - W), W = 7.

Counterpart of `plonky2_tpu/field/ext.py`.

Representations:
* Scalar: tuple (a0, a1) of Python ints — host transcript/verifier.
* Tensor: int64 tensors (u64 bits) with a trailing dim of size 2.
"""

from __future__ import annotations

import torch

from . import gl

W = 7  # X^2 = 7

ZERO = (0, 0)
ONE = (1, 0)


# ------------------------------------------------------------------
# Scalar ops (tuples of Python ints)
# ------------------------------------------------------------------

def from_base_s(a: int):
    return (a, 0)


def add_s(a, b):
    return (gl.add_s(a[0], b[0]), gl.add_s(a[1], b[1]))


def sub_s(a, b):
    return (gl.sub_s(a[0], b[0]), gl.sub_s(a[1], b[1]))


def neg_s(a):
    return (gl.neg_s(a[0]), gl.neg_s(a[1]))


def mul_s(a, b):
    a0, a1 = a
    b0, b1 = b
    c0 = gl.add_s(gl.mul_s(a0, b0), gl.mul_s(W, gl.mul_s(a1, b1)))
    c1 = gl.add_s(gl.mul_s(a0, b1), gl.mul_s(a1, b0))
    return (c0, c1)


def sqr_s(a):
    return mul_s(a, a)


def scalar_mul_s(a, k: int):
    return (gl.mul_s(a[0], k), gl.mul_s(a[1], k))


def inv_s(a):
    a0, a1 = a
    norm = gl.sub_s(gl.mul_s(a0, a0), gl.mul_s(W, gl.mul_s(a1, a1)))
    ninv = gl.inv_s(norm)
    return (gl.mul_s(a0, ninv), gl.mul_s(gl.neg_s(a1), ninv))


def pow_s(a, e: int):
    result = ONE
    base = a
    while e:
        if e & 1:
            result = mul_s(result, base)
        e >>= 1
        base = mul_s(base, base)
    return result


def eq_s(a, b) -> bool:
    return a[0] == b[0] and a[1] == b[1]


# ------------------------------------------------------------------
# Tensor ops: shape (..., 2)
# ------------------------------------------------------------------

def from_base(a):
    """Lift a base-field tensor (...,) to the extension (..., 2)."""
    return torch.stack([a, torch.zeros_like(a)], dim=-1)


def scalar(c, device="cpu"):
    """Extension scalar (c0, c1) -> tensor of shape (2,)."""
    return gl.to_tensor([c[0], c[1]], device)


def add(a, b):
    return gl.add(a, b)       # componentwise


def sub(a, b):
    return gl.sub(a, b)


def neg(a):
    return gl.neg(a)


def mul(a, b):
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    w_a1b1 = gl.mul(gl.mul(a1, b1), gl.full_like(a1, W))
    c0 = gl.add(gl.mul(a0, b0), w_a1b1)
    c1 = gl.add(gl.mul(a0, b1), gl.mul(a1, b0))
    return torch.stack([c0, c1], dim=-1)


def mul_base(a, b_base):
    """Extension tensor * base-field tensor (broadcast over the last dim)."""
    return gl.mul(a, b_base[..., None])


def sqr(a):
    return mul(a, a)


def inv(a):
    a0, a1 = a[..., 0], a[..., 1]
    norm = gl.sub(gl.mul(a0, a0), gl.mul(gl.full_like(a1, W), gl.mul(a1, a1)))
    ninv = gl.inv(norm)
    return torch.stack([gl.mul(a0, ninv), gl.mul(gl.neg(a1), ninv)], dim=-1)


def _host_powers(base, k: int):
    """[base^0 .. base^(k-1)] as a list of scalars."""
    out = [ONE]
    for _ in range(k - 1):
        out.append(mul_s(out[-1], base))
    return out


def powers(base, n: int, device="cpu"):
    """[base^0 .. base^(n-1)] as an (n, 2) tensor on `device`.

    Row i = m*j + r holds (base^m)^j * base^r, m = 2^ceil(log2(n)/2): two
    host tables of about sqrt(n) powers each, copied over, and one broadcast
    product on the device."""
    m = 1 << ((n - 1).bit_length() + 1) // 2
    lo = _host_powers(base, m)
    hi = _host_powers(mul_s(lo[-1], base), -(-n // m))
    table = mul(gl.to_tensor(hi, device)[:, None], gl.to_tensor(lo, device)[None])
    return table.reshape(-1, 2)[:n]
