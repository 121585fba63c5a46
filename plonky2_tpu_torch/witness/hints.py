"""Named witness hints: gadget hint generators as (name, params, deps, outs).

Host copy of the part of `plonky2_tpu/witness/hints.py` that the ported
builder calls: the registry, `NamedGenerator`, the field hint
`inv_or_zero` (for `is_equal`), and the biguint, nonnative and GLV hints
of the secp256k1 gadgets.  A hint maps (params, dep values) to the values
of its `outs`, in order; biguints travel as little-endian u32 limbs.  The
extension and lookup hints arrive with their gates.
"""

from __future__ import annotations

from ..field import gl
from .witness import Generator

HINTS: dict = {}


def hint_fn(name: str):
    def reg(fn):
        if name in HINTS:
            raise ValueError(f"duplicate hint {name}")
        HINTS[name] = fn
        return fn
    return reg


class NamedGenerator(Generator):
    """Serializable hint: run() zips `outs` with the registry fn's values."""

    __slots__ = ("name", "params", "deps", "outs")

    def __init__(self, name: str, params: dict, deps: list, outs: list):
        if name not in HINTS:
            raise ValueError(f"unknown hint {name}")
        self.name = name
        self.params = params
        self.deps = deps
        self.outs = outs

    def run(self, get):
        vals = [get(d) for d in self.deps]
        return list(zip(self.outs, HINTS[self.name](self.params, vals)))


def biguint_to_int(limbs: list) -> int:
    """The integer whose 32-bit limbs, least significant first, are `limbs`."""
    v = 0
    for i, l in enumerate(limbs):
        v |= int(l) << (32 * i)
    return v


def big_from_int(v: int, n: int) -> list:
    """The low `n` 32-bit limbs of `v`, least significant first."""
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


@hint_fn("inv_or_zero")
def _inv_or_zero(p, vals):
    d = vals[0]
    return [gl.inv_s(d) if d else 0]


@hint_fn("biguint_div_rem")
def _biguint_div_rem(p, vals):
    av = biguint_to_int(vals[:p["na"]])
    bv = biguint_to_int(vals[p["na"]:p["na"] + p["nb"]])
    d, r = divmod(av, bv) if bv else (0, 0)
    return big_from_int(d, p["na"]) + big_from_int(r, p["nb"])


@hint_fn("nn_add")
def _nn_add(p, vals):
    m = p["p"]
    s = biguint_to_int(vals[:p["nl"]]) + biguint_to_int(vals[p["nl"]:])
    o = 1 if s >= m else 0
    return big_from_int(s - o * m, p["n_out"]) + [o]


@hint_fn("nn_add_many")
def _nn_add_many(p, vals):
    m = p["p"]
    total, off = 0, 0
    for n in p["nl"]:
        total += biguint_to_int(vals[off:off + n])
        off += n
    o, s = divmod(total, m)
    return big_from_int(s, p["n_out"]) + [o]


@hint_fn("nn_sub")
def _nn_sub(p, vals):
    m = p["p"]
    d = biguint_to_int(vals[:p["nl"]]) - biguint_to_int(vals[p["nl"]:])
    o = 1 if d < 0 else 0
    return big_from_int(d + o * m, p["n_out"]) + [o]


@hint_fn("nn_mul")
def _nn_mul(p, vals):
    m = p["p"]
    o, s = divmod(biguint_to_int(vals[:p["nl"]]) * biguint_to_int(vals[p["nl"]:]), m)
    return big_from_int(s, p["n_out"]) + big_from_int(o, p["n_ovf"])


@hint_fn("nn_inv")
def _nn_inv(p, vals):
    m = p["p"]
    xv = biguint_to_int(vals)
    iv = pow(xv, m - 2, m) if xv % m else 0
    d = (xv * iv - 1) // m if xv % m else 0
    return big_from_int(iv, p["n_inv"]) + big_from_int(d, p["n_div"])


@hint_fn("nn_div")
def _nn_div(p, vals):
    m = p["p"]
    av = biguint_to_int(vals[:p["nl"]]) % m
    bv = biguint_to_int(vals[p["nl"]:]) % m
    q = av * pow(bv, m - 2, m) % m if bv else 0
    return big_from_int(q, p["n_out"])


@hint_fn("glv_decompose")
def _glv_decompose(p, vals):
    from ..field import secp
    kv = biguint_to_int(vals) % secp.N
    m1, n1, m2, n2 = secp.glv_decompose(kv)
    return (big_from_int(m1, p["n1"]) + big_from_int(m2, p["n2"])
            + [int(n1), int(n2)])
