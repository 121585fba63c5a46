"""The port's NTT / LDE (`plonky2_tpu_torch.ntt`) against the JAX package.

Exact equality (tolerance 0).  The port's plain `lde_from_values_rev` — the
version its CUDA kernels K2 and K3 are held against on the card — and plain
`lde_from_values` (K2-nat's) are compared with the JAX Pallas kernels they
replace, run in interpret mode as the JAX package's own CPU tests run them,
and with the JAX XLA path at sizes the Pallas kernels do not take.  The
kernels' range predicates and K3's host tables are held against the JAX
dispatcher and the JAX tiled kernel's tables.  The JAX references run under
`jax.jit` (one compile per shape instead of one per eager op).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky2_tpu import ntt as jntt
from plonky2_tpu.ntt import pallas_lde, pallas_lde_tiled
from plonky2_tpu.ntt.ntt import PALLAS_LDE_MAX, PALLAS_LDE_TILED_MAX
from plonky2_tpu.ntt.pallas_lde import lde_from_values_pallas, lde_from_values_pallas_rev
from plonky2_tpu_torch.field import gl
from plonky2_tpu_torch import ntt
from plonky2_tpu_torch.ntt import cuda_lde, cuda_lde_tiled
from plonky2_tpu_torch.ntt.ntt import _bitrev_perm

RNG = np.random.RandomState(0xF00D)


def rand_u64(*shape):
    x = RNG.randint(0, 2**63, size=shape, dtype=np.int64).astype(np.uint64)
    return (x * np.uint64(2) + np.uint64(1)) % np.uint64(gl.P)


def _pair(got, want):
    return np.array_equal(gl.from_tensor(got), np.asarray(want))


@pytest.mark.parametrize("log_n,rate", [(8, 3), (9, 2)])
def test_lde_rev_equals_pallas_interpret(log_n, rate):
    vals = rand_u64(3, 1 << log_n)
    cg, lg = ntt.lde_from_values_rev(gl.to_tensor(vals), rate)
    cw, lw = lde_from_values_pallas_rev(jnp.asarray(vals), rate, interpret=True)
    assert _pair(cg, cw) and _pair(lg, lw)


@pytest.mark.parametrize("log_n,rate", [(2, 3), (10, 3)])
def test_lde_rev_equals_jax(log_n, rate):
    vals = rand_u64(2, 1 << log_n)
    cg, lg = ntt.lde_from_values_rev(gl.to_tensor(vals), rate)
    cw, lw = jntt.lde_from_values_rev_jit(jnp.asarray(vals), rate_bits=rate)
    assert _pair(cg, cw) and _pair(lg, lw)
    # the commit-path dispatcher takes the plain version for a CPU tensor
    ca, la = ntt.lde_from_values_rev_auto(gl.to_tensor(vals), rate)
    assert torch.equal(ca, cg) and torch.equal(la, lg)


@jax.jit
def _jax_transforms(v):
    return (jntt.ntt(v), jntt.intt(v), jntt.ntt_to_rev(v), jntt.intt_from_rev(v),
            jntt.coset_lde(v, 2), jntt.coset_lde_rev(v, 2))


@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_transforms_equal_jax(log_n):
    x = rand_u64(2, 1 << log_n)
    xt = gl.to_tensor(x)
    want = _jax_transforms(jnp.asarray(x))
    got = (ntt.ntt(xt), ntt.intt(xt), ntt.ntt_to_rev(xt), ntt.intt_from_rev(xt),
           ntt.coset_lde(xt, 2), ntt.coset_lde_rev(xt, 2))
    for g, w in zip(got, want):
        assert _pair(g, w)
    # round trips
    assert torch.equal(ntt.intt_from_rev(ntt.ntt_to_rev(xt)), xt)
    assert torch.equal(ntt.intt(ntt.ntt(xt)), xt)


def test_eval_polys_at_ext_equals_jax():
    coeffs = rand_u64(5, 256)
    point = (int(rand_u64(1)[0]), int(rand_u64(1)[0]))
    got = gl.from_tensor(ntt.eval_polys_at_ext(gl.to_tensor(coeffs), point))
    assert np.array_equal(got, np.asarray(jntt.eval_polys_at_ext(jnp.asarray(coeffs),
                                                                 point)))
    assert tuple(int(v) for v in got[2]) == \
        jntt.eval_poly_ext_s([int(c) for c in coeffs[2]], point)


def test_k2_wrapper_bounds():
    # the kernel's sizes: 2 <= n <= 2^13, 2^rate <= 64; beyond is K3
    assert cuda_lde.supported(2, 3) and cuda_lde.supported(1 << 13, 6)
    assert not cuda_lde.supported(1, 3)
    assert not cuda_lde.supported(1 << 14, 3)
    assert not cuda_lde.supported(1 << 12, 7)
    assert not cuda_lde.supported(96, 3)
    vals = gl.to_tensor(rand_u64(2, 16))
    before = (cuda_lde.LAUNCHES, cuda_lde.LAUNCHES_NAT, cuda_lde_tiled.LAUNCHES)
    c, lde = ntt.lde_from_values_rev_auto(vals, 3)
    assert torch.equal(lde, ntt.lde_from_values_rev(vals, 3)[1])
    c, lde = ntt.lde_from_values_auto(vals, 3)
    assert torch.equal(lde, ntt.lde_from_values(vals, 3)[1])
    # CPU: plain versions, no launch
    assert (cuda_lde.LAUNCHES, cuda_lde.LAUNCHES_NAT, cuda_lde_tiled.LAUNCHES) == before
    meta = torch.empty((2, 16), dtype=torch.int64, device="meta")
    for dispatch in (ntt.lde_from_values_rev_auto, ntt.lde_from_values_auto):
        with pytest.raises(ValueError):
            dispatch(meta, 3)
    # the wrappers take CUDA tensors only: nothing runs a kernel's plain
    # version for them
    for wrapper, n in ((cuda_lde.lde_from_values_rev_cuda, 16),
                       (cuda_lde.lde_from_values_cuda, 16),
                       (cuda_lde_tiled.lde_from_values_tiled_rev_cuda, 1 << 14)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(torch.zeros((1, n), dtype=torch.int64), 3)


def test_kernel_ranges_match_jax_dispatcher():
    # K2 takes every (n, rate) the JAX dispatcher gives the fused Pallas
    # kernel (and the small n that kernel refuses), K3 exactly those it
    # gives the tiled kernel; the two ranges do not overlap.
    for log_n in range(0, 23):
        n = 1 << log_n
        for rate in range(0, 9):
            jax_k2 = pallas_lde._supported(n, rate) and n <= PALLAS_LDE_MAX
            jax_k3 = (PALLAS_LDE_MAX < n <= PALLAS_LDE_TILED_MAX
                      and pallas_lde_tiled._supported_tiled(n, rate))
            k2, k3 = cuda_lde.supported(n, rate), cuda_lde_tiled.supported(n, rate)
            assert k3 == jax_k3, (n, rate)
            assert k2 == (1 <= log_n <= 13 and rate <= 6), (n, rate)
            assert not jax_k2 or k2, (n, rate)
            assert not (k2 and k3)
    for n in (3 << 14, (1 << 14) + 1):
        assert not cuda_lde_tiled.supported(n, 3)


# (15, 7) and (17, 8) are the kernel's own split of an odd log n (n1 < n2,
# `split_log`); (15, 8) is the JAX kernel's
@pytest.mark.parametrize("log_n,log_n1,rate",
                         [(14, 7, 3), (16, 8, 6), (15, 8, 2), (15, 7, 3), (17, 8, 3)])
def test_k3_host_tables_equal_jax(log_n, log_n1, rate):
    for sign in (-1, 1):
        assert np.array_equal(cuda_lde_tiled.inter_twiddle(log_n, log_n1, sign),
                              pallas_lde_tiled._inter_twiddle(log_n, log_n1, sign))
    u, v = cuda_lde_tiled.scale_vectors(log_n, log_n1, rate, ntt.COSET_SHIFT)
    ju, jv = pallas_lde_tiled._scale_vectors(log_n, log_n1, rate, ntt.COSET_SHIFT)
    assert np.array_equal(u, ju) and np.array_equal(v, jv)


def test_k3_size_lde_rev_auto_equals_jax():
    # the smallest K3 size on a CPU tensor: the dispatcher's plain version
    vals = rand_u64(2, 1 << 14)
    before = cuda_lde_tiled.LAUNCHES
    cg, lg = ntt.lde_from_values_rev_auto(gl.to_tensor(vals), 3)
    assert cuda_lde_tiled.LAUNCHES == before
    cw, lw = jntt.lde_from_values_rev_jit(jnp.asarray(vals), rate_bits=3)
    assert _pair(cg, cw) and _pair(lg, lw)


def test_lde_natural_equals_jax_and_pallas_interpret():
    vals = rand_u64(3, 1 << 9)
    cg, lg = ntt.lde_from_values(gl.to_tensor(vals), 3)
    cw, lw = jntt.lde_from_values_jit(jnp.asarray(vals), rate_bits=3)
    assert _pair(cg, cw) and _pair(lg, lw)
    cp, lp = lde_from_values_pallas(jnp.asarray(vals), 3, interpret=True)
    assert _pair(cg, cp) and _pair(lg, lp)
    ca, la = ntt.lde_from_values_auto(gl.to_tensor(vals), 3)
    assert torch.equal(ca, cg) and torch.equal(la, lg)


# (log n, log n1, rate): the kernel's square split, its odd split and the
# largest coset table of the main paths' sizes
@pytest.mark.parametrize("log_n,log_n1,rate", [(14, 7, 3), (15, 7, 2), (16, 8, 1)])
def test_k3_derived_tables_equal_jax(log_n, log_n1, rate):
    # pass A's twiddle with 1/n folded in, and pass C's coset twiddle (the
    # scale's column-constant factor v times the four-step twiddle), held
    # against the JAX kernel's tables multiplied out in Python ints
    p = gl.P
    t_inv = pallas_lde_tiled._inter_twiddle(log_n, log_n1, -1).astype(object)
    n_inv = pow(1 << log_n, p - 2, p)
    assert np.array_equal(gl.from_tensor(cuda_lde_tiled.inverse_twiddle(log_n, log_n1)),
                          (t_inv * n_inv % p).astype(np.uint64))
    t_fwd = pallas_lde_tiled._inter_twiddle(log_n, log_n1, +1).astype(object)
    _, jv = pallas_lde_tiled._scale_vectors(log_n, log_n1, rate, ntt.COSET_SHIFT)
    want = (jv.astype(object)[:, None, :] * t_fwd[None] % p).astype(np.uint64)
    got = cuda_lde_tiled.coset_twiddle(log_n, log_n1, rate, ntt.COSET_SHIFT)
    assert np.array_equal(gl.from_tensor(got), want)


# K3's register groups (csrc/lde_tiled.cu `group_k`) and K2's
# (csrc/lde.cu `group_k`, 2^11 <= n <= 2^13): a transform of 2^log_l points
# runs its stages as groups of k in registers, from the top index bits
# down.  chip_smoke.py reads the built kernels' own splits.
K3_GROUPS = {7: (4, 3), 8: (4, 4), 9: (3, 3, 3), 10: (4, 3, 3)}
K2_GROUPS = {11: (3, 4, 4), 12: (4, 4, 4), 13: (3, 3, 3, 4)}


def _k3_roots(log_l, sign):
    """[2^(log_l - 1)] powers of w_(2^log_l)^sign, a pass's transform roots."""
    w = gl.primitive_root_of_unity(log_l)
    return gl.to_tensor(gl.host_powers(w if sign > 0 else gl.inv_s(w), 1 << (log_l - 1)))


def _groups_dif_last_axis(x, tw, groups):
    """DIF over the last axis (2^sum(groups) points) in register groups of
    `groups` stages, top index bits first (csrc/ntt_groups.cuh): group (k,
    b) holds elements (hi << (b + k)) | (j << b) | lo; its stage of
    half-size 2^(b + t) multiplies by tw[((j mod 2^t) << b | lo) << (log_l -
    1 - b - t)]."""
    shape, log_l = x.shape, sum(groups)
    b = log_l
    for k in groups:
        b -= k
        lo = torch.arange(1 << b)
        for t in range(k - 1, -1, -1):
            y = x.reshape(*shape[:-1], -1, 1 << (k - 1 - t), 2, 1 << t, 1 << b)
            q = torch.arange(1 << t)
            w = tw[((q[:, None] << b) | lo[None, :]) << (log_l - 1 - b - t)]
            e, o = y[..., 0, :, :], y[..., 1, :, :]
            x = torch.stack([gl.add(e, o), gl.mul(gl.sub(e, o), w)], dim=-3).reshape(shape)
    return x


def _k3_pass_model(vals, rate):
    """K3's four passes in torch: A column inverse DIF and `inverse_twiddle`;
    B row inverse DIF and the natural-order store; per coset block, C the
    scale u, column DIF and `coset_twiddle`, D row DIF."""
    b, n = vals.shape
    log_n = n.bit_length() - 1
    l1, l2 = cuda_lde_tiled.split_log(log_n)
    n1, n2 = 1 << l1, 1 << l2

    def cols(x, log_l, sign):
        return _groups_dif_last_axis(x.transpose(-1, -2), _k3_roots(log_l, sign),
                                     K3_GROUPS[log_l]).transpose(-1, -2)

    x = cols(gl.to_tensor(vals).reshape(b, n1, n2), l1, -1)
    x = _groups_dif_last_axis(gl.mul(x, cuda_lde_tiled.inverse_twiddle(log_n, l1)),
                              _k3_roots(l2, -1), K3_GROUPS[l2])
    nat = torch.from_numpy(_bitrev_perm(l1)[:, None] + n1 * _bitrev_perm(l2)[None, :])
    coeffs = torch.empty((b, n), dtype=gl.DTYPE)
    coeffs[:, nat.reshape(-1)] = x.reshape(b, n)
    u, _ = cuda_lde_tiled.scale_vectors(log_n, l1, rate, ntt.COSET_SHIFT)
    coset_tw = cuda_lde_tiled.coset_twiddle(log_n, l1, rate, ntt.COSET_SHIFT)
    blocks = []
    for kk in range(1 << rate):
        y = cols(gl.mul(coeffs.reshape(b, n1, n2), gl.to_tensor(u[kk])[:, None]), l1, +1)
        blocks.append(_groups_dif_last_axis(gl.mul(y, coset_tw[kk]), _k3_roots(l2, +1),
                                            K3_GROUPS[l2]).reshape(b, n))
    return coeffs, torch.cat(blocks, dim=1)


# [1, 2^15] is the odd split, n1 < n2
@pytest.mark.parametrize("rows,log_n,rate", [(2, 14, 3), (1, 15, 2)])
def test_k3_pass_model_equals_jax(rows, log_n, rate):
    vals = rand_u64(rows, 1 << log_n)
    cg, lg = _k3_pass_model(vals, rate)
    cw, lw = jntt.lde_from_values_rev_jit(jnp.asarray(vals), rate_bits=rate)
    assert _pair(cg, cw) and _pair(lg, lw)


# every split of K3, the three-group ones (2^9: 3+3+3, 2^10: 4+3+3)
# included, which the pass model's sizes do not reach, and every split of
# K2 (ids k2-<log n>); against the port's plain DIF (held against JAX's in
# test_transforms_equal_jax)
@pytest.mark.parametrize("groups", [pytest.param(g, id=str(log_l))
                                    for log_l, g in sorted(K3_GROUPS.items())]
                         + [pytest.param(g, id=f"k2-{log_n}")
                            for log_n, g in sorted(K2_GROUPS.items())])
def test_k3_register_groups_equal_plain_dif(groups):
    log_l = sum(groups)
    x = gl.to_tensor(rand_u64(3, 1 << log_l))
    for sign in (+1, -1):
        got = _groups_dif_last_axis(x, _k3_roots(log_l, sign), groups)
        assert torch.equal(got, ntt.ntt_to_rev(x, inverse=sign < 0))


def _k2_model(vals, rate):
    """K2's two launches for 2^11 <= n <= 2^13 in torch, from the kernel's
    own host tables (`cuda_lde._tables`): the inverse DIF in register
    groups, times 1/n into natural-order coefficients; then for each coset
    k the scale (shift * w_N^k)^j at the load, the forward DIF in the same
    groups, and the block placed at rev_rate(k) (K2-rev) or interleaved at
    k + 2^rate * i in natural order (K2-nat)."""
    b, n = vals.shape
    log_n = n.bit_length() - 1
    groups = K2_GROUPS[log_n]
    tw_inv, tw_fwd, pows = cuda_lde._tables(log_n, rate, ntt.COSET_SHIFT % gl.P, "cpu")
    x = _groups_dif_last_axis(gl.to_tensor(vals), tw_inv, groups)   # x[r] = n * c[rev(r)]
    rev_n = torch.from_numpy(_bitrev_perm(log_n))
    coeffs = gl.mul(x, gl.full((), gl.inv_s(n), "cpu"))[:, rev_n]
    rev_blocks, nat = [None] * (1 << rate), torch.empty((b, n << rate), dtype=gl.DTYPE)
    for k in range(1 << rate):
        y = _groups_dif_last_axis(gl.mul(coeffs, pows[k]), tw_fwd, groups)
        rev_blocks[int(_bitrev_perm(rate)[k])] = y
        nat[:, k::1 << rate] = y[:, rev_n]
    return coeffs, torch.cat(rev_blocks, dim=1), nat


@pytest.mark.parametrize("rows,log_n,rate", [(2, 12, 3), (1, 13, 2)])
def test_k2_launch_model_equals_jax(rows, log_n, rate):
    vals = rand_u64(rows, 1 << log_n)
    cg, lg, ng = _k2_model(vals, rate)
    cw, lw = jntt.lde_from_values_rev_jit(jnp.asarray(vals), rate_bits=rate)
    assert _pair(cg, cw) and _pair(lg, lw)
    # K2-nat's order, against the plain natural LDE (held against JAX's in
    # test_lde_natural_equals_jax_and_pallas_interpret)
    assert torch.equal(ng, ntt.lde_from_values(gl.to_tensor(vals), rate)[1])
