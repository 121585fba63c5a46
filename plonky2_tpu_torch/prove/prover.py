"""The prover: witness -> proof, on the device of the circuit's tensors.

Counterpart of `plonky2_tpu/prove/prover.py` (`_make_kernels`, `prove`
and `_prove_impl`, with its mesh path).  Phases and placement:

1. witness generation         host (native tape + batched aux fill)
2. wire LDE + Merkle cap      device: kernel K2 (n <= 2^13) or K3, then K1
                              under the tree
3. permutation Z polys        device: plain torch, K2/K3 + K1 for the commit
   (+ logUp helper polys)     (lookup circuits: one batched inverse, one scan)
4. quotient on the 8n coset   device: plain torch, K1 for the commit
5. openings at zeta           device: plain torch
6. FRI                        device: plain torch folds, K1 trees and grind

Every Merkle tree, the transcript and the grind use the config's
transcript hasher: Poseidon (K1 under each tree and the grind) or Keccak
(plain torch in their place); the public-input hash uses its in-circuit
hasher.

The Pallas kernels of the JAX package are ported as hand-written CUDA (K1,
K2, K3); the phases that XLA compiled there (quotient, Z, composite, fold,
openings) start here as plain torch ops.  Host and device meet only at
transcript points: a Merkle cap or opening values crossing into the
Fiat-Shamir challenger.

With a mesh (`parallel.Mesh`, `prove(pd, inputs, mesh=...)`) the host
phases still run once, and the device phases are placed as the JAX
prover's `_MeshPlacer` places them: each LDE per poly shard (K2 or K3),
its pad polys cut off, then the all-to-all to row shards; every Merkle tree
sharded by rows (`ShardedMerkleTree`, K1 per shard); Z and logUp's running
sum per row shard over H, their exclusive scans carried across shards
(`_exclusive_scan_mesh`); the quotient per row shard, its iNTT and LDE on
the mesh's first device; the openings per poly shard; the FRI composite,
the first fold layer's tree and its fold per row shard, and the later
layers, the final polynomial, the grind and the query gathers on the
first device.  The proof is the same bytes at any mesh size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import ext, gl
from ..fri import fri_prove
from ..merkle import MerkleTree, ShardedMerkleTree
from ..ntt import (COSET_SHIFT, eval_polys_at_ext, host_powers,
                   lde_from_values_rev_auto)
from ..ntt.ntt import _bitrev_perm, coset_lde_rev, intt_from_rev
from ..transcript import Challenger
from ..utils import timed_span
from ..witness import generate_witness
from ..witness.tape import generate_witness_tape
from .proof import OpeningSet, Proof


def _exclusive_scan(r, op, identity: int):
    """Exclusive modular scan along dim -1 with `op` (gl.mul or gl.add),
    starting from `identity`: a log-step (Hillis-Steele) scan, since torch
    has no modular cumprod or cumsum."""
    n = r.shape[-1]
    incl = r
    k = 1
    while k < n:
        incl = torch.cat([incl[..., :k], op(incl[..., k:], incl[..., :-k])],
                         dim=-1)
        k *= 2
    first = gl.full(r.shape[:-1] + (1,), identity, r.device)
    return torch.cat([first, incl[..., :-1]], dim=-1)


def _prefix_product(r):
    """Exclusive modular prefix product along dim -1 (Z's grand product)."""
    return _exclusive_scan(r, gl.mul, 1)


def _prefix_sum(r):
    """Exclusive modular prefix sum along dim -1 (logUp's running sum S:
    S[0] = 0, S[i] = sum_{j<i} r[j])."""
    return _exclusive_scan(r, gl.add, 0)


def _exclusive_scan_mesh(mesh, shards, op, identity: int):
    """`_exclusive_scan` of the mesh's row shards side by side along dim -1:
    each shard's local scan, then op with the scan of all earlier shards'
    totals (d values a row, scanned on the mesh's first device)."""
    local = [_exclusive_scan(r, op, identity) for r in shards]
    totals = mesh.gather([op(lo[..., -1:], r[..., -1:]) for lo, r in zip(local, shards)])
    carry = _exclusive_scan(totals, op, identity)
    return [op(lo, carry[..., j:j + 1].to(lo.device)) for j, lo in enumerate(local)]


def _scalar(c: int, device) -> torch.Tensor:
    return gl.full((), c, device)


def _weighted_sum(terms, weights: list[int]):
    """sum_t terms[t] * weights[t] mod p for a stacked [T, m] tensor."""
    w = gl.to_tensor(weights, terms.device)[:, None]
    return gl.sum_mod(gl.mul(terms, w), dim=0)


def _ext_alpha_powers(alpha, count: int, offset, device):
    """[count, 2] tensor of offset * alpha^i (host-computed)."""
    out = []
    cur = offset
    for _ in range(count):
        out.append(cur)
        cur = ext.mul_s(cur, alpha)
    return gl.to_tensor(out, device)


class _Kernels:
    """Per-circuit device phases (the JAX package's `_make_kernels`)."""

    def __init__(self, common, device):
        from ..gates.lookup import lookup_info
        self.common = common
        self.device = device
        cfg = common.config
        rate = cfg.fri.rate_bits
        self.n = 1 << common.degree_bits
        self.N = self.n << rate
        self.nc = cfg.num_challenges
        self.nr = cfg.num_routed_wires
        self.qf = cfg.max_quotient_degree_factor
        self.K = common.num_partial_products + 1
        self.lki = lki = lookup_info(common)
        # the zs oracle: Z and partial products, then per challenge the
        # logUp block [A_0 .. A_{k-1}, S] (gates/lookup.py)
        self.n_zb = self.nc + self.nc * (self.K - 1)
        self.pcc = lki.get("polys_per_challenge", 0)
        self.r1_idx = list(range(self.nc))       # polys opened at zeta*g
        if lki["has"]:
            self.r1_idx += [self.n_zb + c * self.pcc + lki["k"]
                            for c in range(self.nc)]
        # Chunk the 8n domain so live tensors stay ~flat (2^18 points).
        self.M = min(self.N, 1 << 18)
        # zs(g*x) in bit-reversed order: natural order is a roll by 2^rate;
        # conjugating by the bit-reversal permutation gives a fixed gather.
        rev_N = _bitrev_perm(common.degree_bits + rate)
        nxt = np.empty(self.N, dtype=np.int64)
        nxt[rev_N] = rev_N[(np.arange(self.N) + (1 << rate)) % self.N]
        self.nxt = torch.from_numpy(nxt).to(device)

    def _chunk_products(self, num, den):
        K, qf, nr = self.K, self.qf, self.nr
        pad = K * qf - nr
        if pad:
            ones = torch.ones((pad,) + num.shape[1:], dtype=gl.DTYPE,
                              device=num.device)
            num = torch.cat([num, ones], dim=0)
            den = torch.cat([den, ones], dim=0)
        cn = num.reshape(K, qf, *num.shape[1:])
        cd = den.reshape(K, qf, *den.shape[1:])
        pn, pdn = cn[:, 0], cd[:, 0]
        for j in range(1, qf):
            pn = gl.mul(pn, cn[:, j])
            pdn = gl.mul(pdn, cd[:, j])
        return pn, pdn

    def _z_ratio(self, routed, sigma, k_arr, g_pows, beta_c: int, gamma_c: int):
        """One challenge's chunk ratios [K, m] over the points of g_pows,
        and their product [m], the factor of Z's grand product."""
        dev = routed.device
        beta, gamma = _scalar(beta_c, dev), _scalar(gamma_c, dev)
        num = gl.add(gl.add(routed, gl.mul(gl.mul(beta, k_arr[:, None]),
                                           g_pows[None, :])), gamma)
        den = gl.add(gl.add(routed, gl.mul(beta, sigma)), gamma)
        pn, pdn = self._chunk_products(num, den)
        ratio = gl.mul(pn, gl.inv(pdn))              # [K, m]
        full = ratio[0]
        for m in range(1, self.K):
            full = gl.mul(full, ratio[m])
        return ratio, full

    def _z_partials(self, z, ratio) -> list:
        """The K - 1 partial products of one challenge from its Z."""
        pps = []
        acc = z
        for m in range(self.K - 1):
            acc = gl.mul(acc, ratio[m])
            pps.append(acc)
        return pps

    def z_phase(self, routed, sigma, k_arr, g_pows, betas, gammas):
        """Z and partial-product polynomials over H: [nc + nc*(K-1), n]."""
        zs, pps = [], []
        for c in range(self.nc):
            ratio, full = self._z_ratio(routed, sigma, k_arr, g_pows, betas[c], gammas[c])
            z = _prefix_product(full)
            zs.append(z)
            pps += self._z_partials(z, ratio)
        return torch.stack(zs + pps, dim=0)

    def z_phase_mesh(self, mesh, routed, sigma, k_arr, g_pows, betas, gammas):
        """`z_phase` on the mesh's row shards over H (each argument but the
        challenges a list of d shards) -> its row shards; Z's grand product
        carried across shards."""
        d = mesh.size
        zs, pps = [[] for _ in range(d)], [[] for _ in range(d)]
        for c in range(self.nc):
            parts = [self._z_ratio(routed[j], sigma[j], k_arr[j], g_pows[j], betas[c],
                                   gammas[c]) for j in range(d)]
            z = _exclusive_scan_mesh(mesh, [full for _, full in parts], gl.mul, 1)
            for j in range(d):
                zs[j].append(z[j])
                pps[j] += self._z_partials(z[j], parts[j][0])
        return [torch.stack(zs[j] + pps[j], dim=0) for j in range(d)]

    def lookup_phase(self, routed, lk_masks, tb_masks, lams, lgams):
        """logUp helper polys over H: per challenge, per slot
        A_s = mu_s / (lgam - (x + lam*y)) with mu_s = tb_mask*m - lk_mask
        (one batched inverse for every challenge and slot), then the
        exclusive running sum S of sum_s A_s -> [nc * (k + 1), n], per
        challenge [A_0 .. A_{k-1}, S].  routed [nr, n]; the masks [k, n]
        are 0/1 (`_lookup_masks`)."""
        As = self._lookup_As(routed, lk_masks, tb_masks, lams, lgams)
        S = _prefix_sum(gl.sum_mod(As, dim=1))                    # [nc, n]
        return self._lookup_block(As, S)

    def lookup_phase_mesh(self, mesh, routed, lk_masks, tb_masks, lams, lgams):
        """`lookup_phase` on the mesh's row shards over H -> its row shards;
        the running sum S carried across shards."""
        As = [self._lookup_As(r, lk, tb, lams, lgams)
              for r, lk, tb in zip(routed, lk_masks, tb_masks)]
        S = _exclusive_scan_mesh(mesh, [gl.sum_mod(a, dim=1) for a in As], gl.add, 0)
        return [self._lookup_block(a, s) for a, s in zip(As, S)]

    def _lookup_As(self, routed, lk_masks, tb_masks, lams, lgams):
        """The helper polys A [nc, k, m] over the points of `routed`."""
        k = self.lki["k"]
        dev = routed.device
        x, y, m = routed[0:3 * k:3], routed[1:3 * k:3], routed[2:3 * k:3]
        mu = gl.sub(gl.mul(tb_masks, m), lk_masks)                # [k, m]
        lam = gl.to_tensor(lams, dev)[:, None, None]
        lgam = gl.to_tensor(lgams, dev)[:, None, None]
        denom = gl.sub(lgam, gl.add(x, gl.mul(lam, y)))           # [nc, k, m]
        return gl.mul(mu, gl.inv(denom))

    def _lookup_block(self, As, S):
        """A [nc, k, m] and S [nc, m] -> per challenge [A_0 .. A_{k-1}, S]."""
        return torch.cat([As, S[:, None]], dim=1).reshape(self.nc * (self.lki["k"] + 1), -1)

    def lookup_terms(self, c, wires_c, zs_c, zs_next_c, l1_c, filts, lam, lgam):
        """Challenge c's logUp vanishing terms, in the verifier's order:
        L1*S; per slot A*(lgam - combo) - mu with the normalized filters
        `filts` {gi: filt_gi * kappa^-1}; then S_next - S - sum(A)."""
        lki, k = self.lki, self.lki["k"]
        base = self.n_zb + c * self.pcc
        S, S_next = zs_c[base + k], zs_next_c[base + k]
        terms = [gl.mul(l1_c, S)]
        sumA = None
        for s in range(k):
            A = zs_c[base + s]
            combo = gl.add(wires_c[3 * s], gl.mul(lam, wires_c[3 * s + 1]))
            mu = torch.zeros_like(A)
            for gi, ns, _ in lki["tb"]:
                if s < ns:
                    mu = gl.add(mu, gl.mul(filts[gi], wires_c[3 * s + 2]))
            for gi, ns, _ in lki["lk"]:
                if s < ns:
                    mu = gl.sub(mu, filts[gi])
            terms.append(gl.sub(gl.mul(A, gl.sub(lgam, combo)), mu))
            sumA = A if sumA is None else gl.add(sumA, A)
        terms.append(gl.sub(gl.sub(S_next, S), sumA))
        return terms

    def quotient_chunk(self, wires_c, sel_c, const_c, sigma_c, zs_c, zs_next_c,
                       x_c, zh_inv_c, l1_c, k_arr, betas, gammas, alphas,
                       lams, lgams, pi_hash):
        """One domain chunk -> [nc, m] quotient values.

        Each challenge's accumulator folds, by powers of its alpha, the
        vanishing terms of ALL challenges, then each gate's constraint slots
        times its selector filter: the verifier's term order."""
        from ..gates.base import BatchAlg, EvalVars
        common, nc, nr, K = self.common, self.nc, self.nr, self.K
        dev = x_c.device
        one = torch.ones_like(x_c)
        sel_info = common.selector_info
        many = len(sel_info.groups) > 1

        def filt_of(gi):
            s = sel_c[sel_info.gate_group[gi]]
            filt = one
            for other in sel_info.groups[sel_info.gate_group[gi]]:
                if other != gi:
                    filt = gl.mul(filt, gl.sub(gl.full_like(s, other), s))
            if many:
                filt = gl.mul(filt, gl.sub(gl.full_like(s, sel_info.unused), s))
            return filt

        lki = self.lki
        if lki["has"]:
            # normalized filters: filt_gi * kappa^-1 equals the 0/1 masks
            # of lookup_phase on H (gates/lookup.py lookup_info)
            filts = {gi: gl.mul(filt_of(gi), _scalar(kinv, dev))
                     for gi, _, kinv in lki["lk"] + lki["tb"]}
        vterms = []
        for c in range(nc):
            beta, gamma = _scalar(betas[c], dev), _scalar(gammas[c], dev)
            z = zs_c[c]
            pps = [zs_c[nc + c * (K - 1) + m] for m in range(K - 1)]
            vterms.append(gl.mul(l1_c, gl.sub(z, one)))
            accs = [z] + pps + [zs_next_c[c]]
            num = gl.add(gl.add(wires_c[:nr], gl.mul(gl.mul(beta, k_arr[:, None]),
                                                     x_c[None, :])), gamma)
            den = gl.add(gl.add(wires_c[:nr], gl.mul(beta, sigma_c)), gamma)
            pn, pdn = self._chunk_products(num, den)
            for m in range(K):
                vterms.append(gl.sub(gl.mul(accs[m + 1], pdn[m]),
                                     gl.mul(accs[m], pn[m])))
            if lki["has"]:
                vterms += self.lookup_terms(
                    c, wires_c, zs_c, zs_next_c, l1_c, filts,
                    _scalar(lams[c], dev), _scalar(lgams[c], dev))
        vterms = torch.stack(vterms)
        T0 = vterms.shape[0]
        maxc = max((g.num_constraints for g in common.gates), default=0)
        apows = [gl.host_powers(alphas[c], T0 + maxc).tolist() for c in range(nc)]
        chal_accs = [_weighted_sum(vterms, apows[c][:T0])
                     for c in range(nc)]

        shape = x_c.shape
        alg = BatchAlg(shape, dev)
        pi_arrs = [gl.full(shape, pi_hash[i], dev) for i in range(4)]
        for gi, gate in enumerate(common.gates):
            if hasattr(gate, "eval_batch_fast"):
                cs = gate.eval_batch_fast(wires_c, const_c, pi_arrs)
            else:
                vars_ = EvalVars([wires_c[i] for i in range(gate.num_wires)],
                                 [const_c[i] for i in range(const_c.shape[0])],
                                 pi_arrs)
                cs = gate.eval(vars_, alg)
                if not cs:
                    continue
                cs = torch.stack(cs)
            filt = filt_of(gi)
            for c in range(nc):
                gacc = _weighted_sum(cs, apows[c][T0:T0 + cs.shape[0]])
                chal_accs[c] = gl.add(chal_accs[c], gl.mul(filt, gacc))
        return torch.stack([gl.mul(a, zh_inv_c) for a in chal_accs], dim=0)

    def quotient_phase(self, wires_lde, sel_lde, const_lde, sigma_lde, zs_pp_lde,
                       x_lde, zh_inv, l1, k_arr, betas, gammas, alphas,
                       lams, lgams, pi_hash, sinv_pows):
        """-> (q_polys [nc << rate, n] natural coeffs, q_lde bit-reversed)."""
        zs_next = zs_pp_lde.index_select(-1, self.nxt)
        tq = self.quotient_values(wires_lde, sel_lde, const_lde, sigma_lde, zs_pp_lde,
                                  zs_next, x_lde, zh_inv, l1, k_arr, betas, gammas,
                                  alphas, lams, lgams, pi_hash)
        return self.quotient_finish(tq, sinv_pows)

    def quotient_values(self, wires_lde, sel_lde, const_lde, sigma_lde, zs_pp_lde,
                        zs_next, x_lde, zh_inv, l1, *challenges):
        """The quotient's values [nc, m] over the m points given, in chunks
        of at most M points."""
        outs = []
        for s0 in range(0, x_lde.shape[-1], self.M):
            def cut(a, s0=s0):
                return a[..., s0:s0 + self.M]
            outs.append(self.quotient_chunk(
                cut(wires_lde), cut(sel_lde), cut(const_lde), cut(sigma_lde),
                cut(zs_pp_lde), cut(zs_next), cut(x_lde), cut(zh_inv), cut(l1),
                *challenges))
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]

    def quotient_finish(self, tq, sinv_pows):
        """Values [nc, N] bit-reversed -> (q_polys [nc << rate, n], q_lde)."""
        rate = self.common.config.fri.rate_bits
        q_coeffs = gl.mul(intt_from_rev(tq), sinv_pows)
        q_polys = q_coeffs.reshape(self.nc << rate, self.n)
        return q_polys, coset_lde_rev(q_polys, rate)

    def zs_next_mesh(self, mesh, zs_pp_lde):
        """zs(g*x) on the mesh's row shards.  The step g changes only the
        natural index's bits above the rate, and a shard is the top log2(d)
        bits of the bit-reversed index, which come from the bits below it: so
        for d <= 2^rate the gather stays in each shard; above, it is made on
        the first device and split."""
        if mesh.size > 1 << self.common.config.fri.rate_bits:
            return mesh.rows(mesh.gather(zs_pp_lde).index_select(-1, self.nxt.to(
                mesh.devices[0])))
        w = self.N // mesh.size
        return [z.index_select(-1, (self.nxt[j * w:(j + 1) * w] - j * w).to(z.device))
                for j, z in enumerate(zs_pp_lde)]

    def composite_chunk(self, cs_lde, wires_lde, zs_pp_lde, q_lde, fri_alpha,
                        zeta, zeta_next, o0, o1, alpha_b0, x_lde):
        """sum_i alpha^i (f_i(x) - f_i(zeta)) / (x - zeta) over the batch
        plus alpha^B * the zeta*g batch, on one domain chunk -> [m, 2]."""
        dev = x_lde.device
        x_ext = ext.from_base(x_lde)

        def reduce_alpha(polys, offset):
            ap = _ext_alpha_powers(fri_alpha, polys.shape[0], offset, dev)
            r0c = gl.sum_mod(gl.mul(polys, ap[:, 0:1]), dim=0)
            r1c = gl.sum_mod(gl.mul(polys, ap[:, 1:2]), dim=0)
            return torch.stack([r0c, r1c], dim=-1)          # [m, 2]

        r0 = None
        off = ext.ONE
        for polys in (cs_lde, wires_lde, zs_pp_lde, q_lde):
            part = reduce_alpha(polys, off)
            r0 = part if r0 is None else ext.add(r0, part)
            off = ext.mul_s(off, ext.pow_s(fri_alpha, polys.shape[0]))
        r1 = reduce_alpha(zs_pp_lde[self.r1_idx], ext.ONE)

        def e(v):
            return ext.scalar(v, dev).expand(x_ext.shape)

        inv0 = ext.inv(ext.sub(x_ext, e(zeta)))
        inv1 = ext.inv(ext.sub(x_ext, e(zeta_next)))
        f0 = ext.mul(ext.sub(r0, e(o0)), inv0)
        f1 = ext.mul(ext.mul(ext.sub(r1, e(o1)), inv1), e(alpha_b0))
        return ext.add(f0, f1)

    def composite(self, cs_lde, wires_lde, zs_pp_lde, q_lde, *scalars, x_lde):
        outs = []
        for s0 in range(0, x_lde.shape[-1], self.M):
            def cut(a, s0=s0):
                return a[..., s0:s0 + self.M]
            outs.append(self.composite_chunk(
                cut(cs_lde), cut(wires_lde), cut(zs_pp_lde), cut(q_lde),
                *scalars, cut(x_lde)))
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def _lookup_masks(pd, lki):
    """Per-slot [k, n] 0/1 int64 row masks on pd's device: lk[s][r] = 1 on
    the rows of a lookup gate with more than s slots, tb likewise for the
    table gates.  They equal the quotient's normalized filters on H.
    Derived from pd.row_gate, so a loaded circuit derives them too; cached
    on pd."""
    cached = getattr(pd, "_lookup_masks", None)
    if cached is not None:
        return cached
    n = len(pd.row_gate)
    row_gate = np.asarray(pd.row_gate, dtype=np.int64)
    masks = []
    for gates in (lki["lk"], lki["tb"]):
        mk = np.zeros((lki["k"], n), dtype=np.int64)
        for gi, ns, _kinv in gates:
            mk[:ns, row_gate == gi] = 1
        masks.append(torch.from_numpy(mk).to(pd.device))
    pd._lookup_masks = tuple(masks)
    return pd._lookup_masks


def get_kernels(pd) -> _Kernels:
    k = getattr(pd, "_kernels", None)
    if k is None:
        k = _Kernels(pd.common, pd.device)
        pd._kernels = k
    return k


def prove(pd, inputs: dict, mesh=None) -> Proof:
    """A proof of `pd`'s circuit for `inputs`; with `mesh` (a
    `parallel.Mesh` of the circuit's device type, its size dividing n), its
    device phases sharded over the mesh, to the same bytes."""
    if mesh is not None:
        if mesh.device_type != pd.device.type:
            raise ValueError(f"a mesh of {mesh.device_type} devices cannot prove a circuit "
                             f"on {pd.device}")
        if (1 << pd.common.degree_bits) % mesh.size:
            raise ValueError(f"a mesh of {mesh.size} shards does not divide the "
                             f"2^{pd.common.degree_bits} rows")
    span = f"prove (2^{pd.common.degree_bits} rows" + \
        (f", {mesh.size} shards)" if mesh is not None else ")")
    with timed_span(span):
        return _prove_impl(pd, inputs, mesh)


def witness_matrix(pd, inputs: dict):
    """The prover's witness phase (the JAX prover's phase 1): the native
    tape, one vectorized scatter, then every gate's batched aux fill ->
    (wires [num_wires, n] numpy uint64, store)."""
    common = pd.common
    with timed_span("witness generation"):
        store = generate_witness_tape(pd, inputs)
    with timed_span("witness scatter to wire matrix"):
        wires_host = store.scatter(common.config.num_wires, 1 << common.degree_bits)
    with timed_span("witness aux fill (batched)"):
        _aux_fill(pd, wires_host)
    return wires_host, store


def scheduler_witness_matrix(pd, inputs: dict):
    """The same wire matrix through the dynamic scheduler and a scatter
    loop: the reference the tape is held against (the prover never runs
    it) -> (wires, store)."""
    from ..ir.builder import Wire
    common = pd.common
    store = generate_witness(pd, inputs)
    wires_host = np.zeros((common.config.num_wires, 1 << common.degree_bits),
                          dtype=np.uint64)
    for rep, v in store._vals.items():
        if isinstance(rep, Wire):
            wires_host[rep.column, rep.row] = v
        for w in pd.class_wires.get(rep, ()):
            wires_host[w.column, w.row] = v
    _aux_fill(pd, wires_host)
    return wires_host, store


def _aux_fill(pd, wires_host) -> None:
    for gi, gate in enumerate(pd.common.gates):
        rows = pd.gate_rows.get(gi)
        if hasattr(gate, "aux_fill") and rows:
            gate.aux_fill(np.asarray(rows, dtype=np.int64), wires_host)


def _mesh_lde(mesh, poly_shards, p: int, rate: int):
    """Poly shards of values over H, zero-padded (`Mesh.polys`) -> (the
    coefficients' poly shards, the LDE's row shards): per shard the commit
    path's LDE (K2 or K3 on the card), the pad polys cut off before
    anything is committed or opened, then the all-to-all."""
    outs = [lde_from_values_rev_auto(s, rate) for s in poly_shards]
    coeffs = mesh.unpad([c for c, _ in outs], p)
    return coeffs, mesh.polys_to_rows(mesh.unpad([lde for _, lde in outs], p))


def _commit(mesh, lde, cap_height: int, hasher):
    """The Merkle tree of an LDE: whole, or over its row shards."""
    if mesh is None:
        return MerkleTree.build_cols(lde, cap_height, hasher)
    return ShardedMerkleTree.build_cols(mesh, lde, cap_height, hasher)


def _prove_impl(pd, inputs: dict, mesh=None) -> Proof:
    """The prover's phases.  With a mesh, the LDEs, every domain-wide
    tensor and the Merkle trees are lists of the mesh's shards (poly
    shards for the coefficients, row shards for the rest), and the
    unsharded steps run on its first device."""
    common = pd.common
    cfg = common.config
    fri_cfg = cfg.fri
    n = 1 << common.degree_bits
    rate = fri_cfg.rate_bits
    N = n << rate
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    dev = pd.device if mesh is None else mesh.devices[0]
    kernels = get_kernels(pd)

    # ---- 1. witness ----
    wires_host, store = witness_matrix(pd, inputs)
    pi_values = [store.get(t) for t in pd.pi_targets]
    pi_hash = cfg.hasher_module().hash_no_pad_s(pi_values)
    th = cfg.transcript_module()

    # ---- 2. commit wires ----
    _wb = 8 * cfg.num_wires * (2 * n + N)        # read values, write c + LDE
    _mb = 8 * cfg.num_wires * N                  # Merkle leaf read
    with timed_span("wire LDE + Merkle commit", nbytes=_wb + _mb):
        with timed_span("wire LDE (iNTT + coset NTT)", nbytes=_wb):
            wires = gl.to_tensor(wires_host, dev)
            if mesh is None:
                wires_coeffs, wires_lde = lde_from_values_rev_auto(wires, rate)
            else:
                wires_coeffs, wires_lde = _mesh_lde(mesh, mesh.polys(wires),
                                                    cfg.num_wires, rate)
        with timed_span("wire Merkle tree (leaf hash + levels)", nbytes=_mb):
            wires_tree = _commit(mesh, wires_lde, fri_cfg.cap_height, th)
            wires_tree.cap_host()

    ch = Challenger(th)
    ch.observe_cap(pd.cs_tree.cap_host())
    ch.observe_elements(pi_hash)
    ch.observe_cap(wires_tree.cap_host())
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    lki = kernels.lki
    lams = lgams = None                      # logUp's challenges, if any
    if lki["has"]:
        lams = ch.get_n_challenges(nc)
        lgams = ch.get_n_challenges(nc)

    # ---- 3. Z polys + partial products (+ logUp helper polys) over H ----
    g_pows = gl.powers(gl.primitive_root_of_unity(common.degree_bits), n, dev)
    k_arr = gl.to_tensor(common.k_is, dev)
    _zn = kernels.n_zb + nc * kernels.pcc
    with timed_span("permutation Z polys + commit",
                    nbytes=8 * (3 * nr * n + _zn * (2 * n + 2 * N))):
        if mesh is None:
            zs_pp_vals = kernels.z_phase(wires[:nr], pd.sigma_polys, k_arr, g_pows,
                                         betas, gammas)
        else:
            routed = mesh.rows(wires[:nr])
            zs_pp_vals = kernels.z_phase_mesh(mesh, routed, mesh.rows(pd.sigma_polys),
                                              mesh.replicate(k_arr), mesh.rows(g_pows),
                                              betas, gammas)
        if lki["has"]:
            with timed_span("lookup helper polys (logUp)"):
                lk_masks, tb_masks = _lookup_masks(pd, lki)
                if mesh is None:
                    zs_pp_vals = torch.cat([zs_pp_vals, kernels.lookup_phase(
                        wires[:nr], lk_masks, tb_masks, lams, lgams)], dim=0)
                else:
                    lk_vals = kernels.lookup_phase_mesh(
                        mesh, routed, mesh.rows(lk_masks), mesh.rows(tb_masks), lams,
                        lgams)
                    zs_pp_vals = [torch.cat([z, lk], dim=0)
                                  for z, lk in zip(zs_pp_vals, lk_vals)]
        if mesh is None:
            zs_pp_coeffs, zs_pp_lde = lde_from_values_rev_auto(zs_pp_vals, rate)
        else:
            zs_pp_coeffs, zs_pp_lde = _mesh_lde(mesh, mesh.rows_to_polys(zs_pp_vals),
                                                _zn, rate)
        zs_tree = _commit(mesh, zs_pp_lde, fri_cfg.cap_height, th)
        zs_tree.cap_host()
    ch.observe_cap(zs_tree.cap_host())
    alphas = ch.get_n_challenges(nc)

    # ---- 4. quotient ----
    sel_count = len(common.selector_info.groups)
    const_end = sel_count + common.num_constants_polys
    cs_lde = pd.cs_lde if mesh is None else mesh.rows(pd.cs_lde)

    # Every domain table is in bit-reversed order (index r <-> point
    # shift * w^rev(r)) to match the LDE storage layout (fri/fri.py).
    rev_N_perm = _bitrev_perm(common.degree_bits + rate)
    x_nat = host_powers(gl.primitive_root_of_unity(common.degree_bits + rate), N)
    x_lde = gl.mul(gl.to_tensor(x_nat[rev_N_perm], dev), _scalar(COSET_SHIFT, dev))
    shift_n = pow(COSET_SHIFT, n, gl.P)
    w8 = gl.primitive_root_of_unity(rate)
    zh_vals = [(shift_n * pow(w8, j, gl.P) - 1) % gl.P for j in range(1 << rate)]
    zh_nat = np.tile(np.asarray(zh_vals, dtype=np.uint64), N >> rate)
    zh = gl.to_tensor(zh_nat[rev_N_perm], dev)
    zh_inv = gl.inv(zh)
    l1 = gl.mul(zh, gl.inv(gl.mul(gl.sub(x_lde, torch.ones_like(x_lde)),
                                  gl.full_like(x_lde, n))))
    sinv_pows = gl.powers(gl.inv_s(COSET_SHIFT), N, dev)
    challenges = (betas, gammas, alphas, lams, lgams, pi_hash)

    _qr = (pd.cs_lde.shape[0] + cfg.num_wires + _zn) * N
    with timed_span("quotient evaluation + commit",
                    nbytes=8 * (_qr + (nc << rate) * (3 * N))):
        if mesh is None:
            q_polys, q_lde = kernels.quotient_phase(
                wires_lde, cs_lde[:sel_count], cs_lde[sel_count:const_end],
                cs_lde[const_end:], zs_pp_lde, x_lde, zh_inv, l1, k_arr, *challenges,
                sinv_pows)
        else:
            # per row shard; the values gathered for the iNTT and the LDE
            x_lde, zh_inv, l1 = mesh.rows(x_lde), mesh.rows(zh_inv), mesh.rows(l1)
            zs_next = kernels.zs_next_mesh(mesh, zs_pp_lde)
            tq = [kernels.quotient_values(w, c[:sel_count], c[sel_count:const_end],
                                          c[const_end:], z, zn, x, zi, l, k, *challenges)
                  for w, c, z, zn, x, zi, l, k in zip(
                      wires_lde, cs_lde, zs_pp_lde, zs_next, x_lde, zh_inv, l1,
                      mesh.replicate(k_arr))]
            q_polys, q_lde = kernels.quotient_finish(mesh.gather(tq), sinv_pows)
            q_lde = mesh.rows(q_lde)
        q_tree = _commit(mesh, q_lde, fri_cfg.cap_height, th)
        q_tree.cap_host()
    ch.observe_cap(q_tree.cap_host())
    zeta = ch.get_ext_challenge()

    # ---- 5. openings ----
    g = gl.primitive_root_of_unity(common.degree_bits)
    zeta_next = ext.scalar_mul_s(zeta, g)

    with timed_span("openings at zeta"):
        # the polynomials opened at zeta, each a list of shards
        if mesh is None:
            at_zeta = [[pd.cs_coeffs], [wires_coeffs], [zs_pp_coeffs], [q_polys]]
            zs_r1 = zs_pp_coeffs[kernels.r1_idx]
        else:
            at_zeta = [mesh.unpad(mesh.polys(pd.cs_coeffs), pd.cs_coeffs.shape[0]),
                       wires_coeffs, zs_pp_coeffs,
                       mesh.unpad(mesh.polys(q_polys), q_polys.shape[0])]
            zs_r1 = mesh.gather(zs_pp_coeffs, dim=0)[kernels.r1_idx]
        with timed_span("openings: point powers"):
            # one table per (point, device), shared by every call at that point
            devs = dict.fromkeys(s.device for shards in at_zeta for s in shards)
            pows = {(zeta, d): ext.powers(zeta, n, d) for d in devs}
            pows[zeta_next, zs_r1.device] = ext.powers(zeta_next, n, zs_r1.device)

        def open_at(shards, point):
            """Each poly shard at `point` on its device, in polynomial order."""
            return [(int(a), int(b)) for s in shards for a, b in gl.from_tensor(
                eval_polys_at_ext(s, point, pows[point, s.device]))]

        with timed_span("openings: products + sums"):
            cs_open, wires_open, zs_pp_open, q_open = (open_at(s, zeta) for s in at_zeta)
            zs_next_open = open_at([zs_r1], zeta_next)

    openings = OpeningSet(cs_open, wires_open, zs_pp_open, zs_next_open, q_open)
    for e in openings.observe_order():
        ch.observe_ext(e)
    fri_alpha = ch.get_ext_challenge()

    # ---- 6. FRI ----
    batch0_open = cs_open + wires_open + zs_pp_open + q_open
    o0 = ext.ZERO
    for v in reversed(batch0_open):
        o0 = ext.add_s(ext.mul_s(o0, fri_alpha), v)
    o1 = ext.ZERO
    for v in reversed(zs_next_open):
        o1 = ext.add_s(ext.mul_s(o1, fri_alpha), v)
    alpha_b0 = ext.pow_s(fri_alpha, len(batch0_open))
    scalars = (fri_alpha, zeta, zeta_next, o0, o1, alpha_b0)
    with timed_span("FRI (composite + commit phases + queries)",
                    nbytes=8 * (_qr + (nc << rate) * N + 2 * 2 * N)):
        if mesh is None:
            composite = kernels.composite(cs_lde, wires_lde, zs_pp_lde, q_lde, *scalars,
                                          x_lde=x_lde)
        else:
            composite = [kernels.composite(c, w, z, q, *scalars, x_lde=x)
                         for c, w, z, q, x in zip(cs_lde, wires_lde, zs_pp_lde, q_lde,
                                                  x_lde)]
        fri = fri_prove(composite, common.degree_bits, fri_cfg, ch, COSET_SHIFT,
                        [pd.cs_tree, wires_tree, zs_tree, q_tree], mesh=mesh)

    return Proof(
        wires_cap=wires_tree.cap_host(),
        zs_pp_cap=zs_tree.cap_host(),
        quotient_cap=q_tree.cap_host(),
        openings=openings,
        fri=fri,
        public_inputs=pi_values,
    )
