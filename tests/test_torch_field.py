"""The port's Goldilocks and GF(p^2) tensor ops (`plonky2_tpu_torch.field`)
against the JAX package's (`plonky2_tpu.field`).

Field arithmetic is exact, so every comparison is equality: the tolerance
is 0.  Inputs are made with numpy from a fixed seed and the same arrays go
to both packages.  Edge values include 0, 1, p-1, p-2, 2^32-1, 2^32 and
values >= 2^63 (negative as int64), and sums that wrap 2^64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu.field import ext as jext
from plonky2_tpu.field import gl as jgl
from plonky2_tpu_torch import ntt
from plonky2_tpu_torch.field import ext, gl

P = gl.P
EDGE = [0, 1, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, 2**63 - 1, P // 2]


def _inputs(seed, n=600):
    rng = np.random.RandomState(seed)
    rand = rng.randint(0, 2**63, size=n, dtype=np.int64).astype(np.uint64) * np.uint64(2)
    rand = rand % np.uint64(P)
    edge = np.asarray(EDGE, dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, len(edge)), rand])
    b = np.concatenate([np.tile(edge, len(edge)), rand[::-1]])
    return a, b


def _jax(fn, *arrs):
    return np.asarray(fn(*[jnp.asarray(x) for x in arrs]))


def _port(fn, *arrs):
    return gl.from_tensor(fn(*[gl.to_tensor(x) for x in arrs]))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "sqr", "neg", "inv",
                                  "pow7", "mul_wide"])
def test_gl_tensor_ops_equal_jax(name):
    a, b = _inputs(11)
    if name == "inv":
        a = a[a != 0]
    ops = {
        "add": (gl.add, jgl.add, (a, b)),
        "sub": (gl.sub, jgl.sub, (a, b)),
        "mul": (gl.mul, jgl.mul, (a, b)),
        "sqr": (gl.sqr, jgl.sqr, (a,)),
        "neg": (gl.neg, jgl.neg, (a,)),
        "inv": (gl.inv, jgl.inv, (a,)),
        "pow7": (lambda x: gl.pow_const(x, 7), lambda x: jgl.pow_const(x, 7), (a,)),
        "mul_wide": (lambda x, y: torch.stack(gl._mul_wide(x, y)),
                     lambda x, y: jnp.stack(jgl._mul_wide(x, y)), (a, b)),
    }
    port_fn, jax_fn, args = ops[name]
    assert np.array_equal(_port(port_fn, *args), _jax(jax_fn, *args))


def test_gl_scalar_ops_and_constants_equal_jax():
    a, b = _inputs(12, n=50)
    for x, y in zip(a.tolist(), b.tolist()):
        assert gl.add_s(x, y) == jgl.add_s(x, y)
        assert gl.sub_s(x, y) == jgl.sub_s(x, y)
        assert gl.mul_s(x, y) == jgl.mul_s(x, y)
        if x:
            assert gl.inv_s(x) == jgl.inv_s(x)
    assert (gl.P, gl.GENERATOR, gl.TWO_ADICITY) == (jgl.P, jgl.GENERATOR, jgl.TWO_ADICITY)
    for k in (0, 1, 5, 12, 15, 32):
        assert gl.primitive_root_of_unity(k) == jgl.primitive_root_of_unity(k)


def test_gl_reduce128_edges_equal_jax():
    hi = np.asarray([0, 1, 2**64 - 1, 2**32, 2**32 - 1, P - 1, 2**63], dtype=np.uint64)
    lo = np.asarray([2**64 - 1, 0, 2**64 - 1, 2**63, 1, P, P - 1], dtype=np.uint64)
    hi, lo = np.repeat(hi, len(lo)), np.tile(lo, len(hi))
    assert np.array_equal(_port(gl._reduce128, hi, lo), _jax(jgl._reduce128, hi, lo))
    want = [((int(h) << 64) + int(l)) % P for h, l in zip(hi, lo)]
    assert _port(gl._reduce128, hi, lo).tolist() == want


def test_gl_sum_mod_wraps_2_64():
    # 7 copies of p-1 sum past 2^64 several times: torch.sum would wrap mod 2^64
    x = np.full((7, 5), P - 1, dtype=np.uint64)
    x[:, 1] = 2**63
    a, _ = _inputs(13, n=21 * 5)
    x = np.concatenate([x, a[-21 * 5:].reshape(21, 5)])
    got = gl.from_tensor(gl.sum_mod(gl.to_tensor(x), dim=0))
    assert np.array_equal(got, np.asarray(jgl.sum_mod(jnp.asarray(x), axis=0)))
    assert got.tolist() == [sum(int(v) for v in col) % P for col in x.T]


def test_gl_powers_and_roundtrip():
    assert np.array_equal(gl.from_tensor(gl.powers(7, 300)),
                          np.asarray(jgl.powers(7, 300)))
    vals = np.asarray(EDGE, dtype=np.uint64)
    t = gl.to_tensor(vals)
    assert t.dtype == torch.int64
    assert np.array_equal(gl.from_tensor(t), vals)
    assert gl.to_i64(2**64 - 1) == -1 and gl.to_i64(2**63) == -(2**63)


@pytest.mark.parametrize("base", [(0, 0), (1, 0), (P - 2, 0), (2**63 + 5, P - 1),
                                  (123456789, 2**32 + 1)])
@pytest.mark.parametrize("n", [1, 2, 3, 127, 1 << 12, 1 << 16])
def test_ext_powers_equal_host_loop(n, base):
    # ext.powers builds base^(m*j + r) from two ~sqrt(n) host tables and one
    # product; every row must equal the plain loop of n products
    want, cur = [], ext.ONE
    for _ in range(n):
        want.append(cur)
        cur = ext.mul_s(cur, base)
    pows = ext.powers(base, n, "cpu")
    assert pows.shape == (n, 2)
    assert np.array_equal(gl.from_tensor(pows), np.asarray(want, dtype=np.uint64))
    coeffs = gl.to_tensor(_inputs(16, n=n)[0][-n:].reshape(1, n))
    assert torch.equal(ntt.eval_polys_at_ext(coeffs, base, pows=pows),
                       ntt.eval_polys_at_ext(coeffs, base))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "sqr", "inv", "mul_base",
                                  "from_base"])
def test_ext_tensor_ops_equal_jax(name):
    a, b = _inputs(14)
    a2 = np.stack([a, b[::-1]], axis=-1)
    b2 = np.stack([b, a], axis=-1)
    if name == "inv":
        a2 = a2[(a2 != 0).any(axis=-1)]
    ops = {
        "add": (ext.add, jext.add, (a2, b2)),
        "sub": (ext.sub, jext.sub, (a2, b2)),
        "mul": (ext.mul, jext.mul, (a2, b2)),
        "sqr": (ext.sqr, jext.sqr, (a2,)),
        "inv": (ext.inv, jext.inv, (a2,)),
        "mul_base": (ext.mul_base, jext.mul_base, (a2, b)),
        "from_base": (ext.from_base, jext.from_base, (a,)),
    }
    port_fn, jax_fn, args = ops[name]
    assert np.array_equal(_port(port_fn, *args), _jax(jax_fn, *args))


def test_ext_scalar_ops_equal_jax():
    a, b = _inputs(15, n=40)
    for x0, x1, y0, y1 in zip(a[:40].tolist(), b[:40].tolist(),
                              a[40:80].tolist(), b[40:80].tolist()):
        x, y = (x0, x1), (y0, y1)
        assert ext.mul_s(x, y) == jext.mul_s(x, y)
        assert ext.add_s(x, y) == jext.add_s(x, y)
        assert ext.pow_s(x, 1000003) == jext.pow_s(x, 1000003)
        if x != (0, 0):
            assert ext.inv_s(x) == jext.inv_s(x)
