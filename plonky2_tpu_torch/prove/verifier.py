"""Proof verification (host scalar).

Counterpart of `plonky2_tpu/prove/verifier.py`.  Replays the challenger
over the public inputs and the commitments, checks the full constraint
identity at zeta with the gates' generic `eval` over GF(p^2) (`ExtAlg`),
and verifies the FRI proof with the batched-opening combine.  It reads the
host `Proof` and `VerifierData` only and touches no device.
"""

from __future__ import annotations

from ..field import ext, gl
from ..fri.fri import fri_verify, require, rev_bits
from ..gates.base import EvalVars, ExtAlg
from ..gates.lookup import lookup_info
from ..ntt import COSET_SHIFT
from ..transcript import Challenger
from .proof import Proof


def verify(vd, proof: Proof) -> None:
    """Raises ValueError if the proof is invalid."""
    common = vd.common
    cfg = common.config
    fri_cfg = cfg.fri
    n = 1 << common.degree_bits
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    qf = cfg.max_quotient_degree_factor
    K = common.num_partial_products + 1

    require(len(proof.public_inputs) == common.num_public_inputs,
            "public input count")
    pi_hash = cfg.hasher_module().hash_no_pad_s(
        [v % gl.P for v in proof.public_inputs])

    # ---- challenger replay (the prover's observe order) ----
    ch = Challenger(cfg.transcript_module())
    ch.observe_cap(vd.cs_cap)
    ch.observe_elements(pi_hash)
    ch.observe_cap(proof.wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    lki = lookup_info(common)
    if lki["has"]:
        lams = ch.get_n_challenges(nc)
        lgams = ch.get_n_challenges(nc)
    ch.observe_cap(proof.zs_pp_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_ext_challenge()
    for e in proof.openings.observe_order():
        ch.observe_ext(tuple(e))
    fri_alpha = ch.get_ext_challenge()

    # ---- constraint identity at zeta ----
    o = proof.openings
    sel_count = len(common.selector_info.groups)
    n_consts = common.num_constants_polys
    sels = [tuple(e) for e in o.constants_sigmas[:sel_count]]
    consts = [tuple(e) for e in o.constants_sigmas[sel_count:sel_count + n_consts]]
    sigmas = [tuple(e) for e in o.constants_sigmas[sel_count + n_consts:]]
    wires = [tuple(e) for e in o.wires]
    zspp = [tuple(e) for e in o.zs_partial_products]
    zs = zspp[:nc]
    pps = zspp[nc:nc + nc * (K - 1)]
    zs_next = [tuple(e) for e in o.zs_next]
    quotient = [tuple(e) for e in o.quotient]
    n_zb = nc + nc * (K - 1)                  # the logUp block's first row
    pcc = lki.get("polys_per_challenge", 0)
    n_zspp = n_zb + nc * pcc
    require(len(sigmas) == nr and len(zspp) == n_zspp, "opening counts")
    require(len(wires) == cfg.num_wires
            and len(zs_next) == nc * (2 if lki["has"] else 1), "opening counts")
    require(len(quotient) == nc << fri_cfg.rate_bits, "quotient opening count")

    # Z_H(zeta), L_1(zeta)
    zeta_pow_n = ext.pow_s(zeta, n)
    zh_zeta = ext.sub_s(zeta_pow_n, ext.ONE)
    l1_zeta = ext.mul_s(zh_zeta, ext.inv_s(
        ext.scalar_mul_s(ext.sub_s(zeta, ext.ONE), n)))

    sel_info = common.selector_info
    many = len(sel_info.groups) > 1

    def filt_of(gi):
        """Selector filter value at zeta for gate gi (the prover's quotient
        uses the same formula)."""
        s = sels[sel_info.gate_group[gi]]
        f = ext.ONE
        for other in sel_info.groups[sel_info.gate_group[gi]]:
            if other != gi:
                f = ext.mul_s(f, ext.sub_s(ext.from_base_s(other), s))
        if many:
            f = ext.mul_s(f, ext.sub_s(ext.from_base_s(sel_info.unused), s))
        return f

    terms = []
    for c in range(nc):
        beta, gamma = betas[c], gammas[c]
        terms.append(ext.mul_s(l1_zeta, ext.sub_s(zs[c], ext.ONE)))
        accs = [zs[c]] + pps[c * (K - 1):(c + 1) * (K - 1)] + [zs_next[c]]
        for m in range(K):
            pn = ext.ONE
            pd_ = ext.ONE
            for i in range(m * qf, min((m + 1) * qf, nr)):
                kx = ext.scalar_mul_s(zeta, gl.mul_s(beta, common.k_is[i]))
                num_i = ext.add_s(ext.add_s(wires[i], kx), ext.from_base_s(gamma))
                den_i = ext.add_s(ext.add_s(wires[i],
                                            ext.scalar_mul_s(sigmas[i], beta)),
                                  ext.from_base_s(gamma))
                pn = ext.mul_s(pn, num_i)
                pd_ = ext.mul_s(pd_, den_i)
            terms.append(ext.sub_s(ext.mul_s(accs[m + 1], pd_),
                                   ext.mul_s(accs[m], pn)))
        if lki["has"]:
            # logUp terms at zeta, in the prover's order (prover.py
            # lookup_terms): L1*S, per slot A*(lgam - combo) - mu, then
            # S_next - S - sum(A)
            kk = lki["k"]
            lam, lgam = lams[c], lgams[c]
            S = zspp[n_zb + c * pcc + kk]
            S_next = zs_next[nc + c]
            terms.append(ext.mul_s(l1_zeta, S))
            sum_a = ext.ZERO
            for s in range(kk):
                A = zspp[n_zb + c * pcc + s]
                combo = ext.add_s(wires[3 * s],
                                  ext.scalar_mul_s(wires[3 * s + 1], lam))
                mu = ext.ZERO
                for gi, ns, kinv in lki["tb"]:
                    if s < ns:
                        nf = ext.scalar_mul_s(filt_of(gi), kinv)
                        mu = ext.add_s(mu, ext.mul_s(nf, wires[3 * s + 2]))
                for gi, ns, kinv in lki["lk"]:
                    if s < ns:
                        mu = ext.sub_s(mu, ext.scalar_mul_s(filt_of(gi), kinv))
                terms.append(ext.sub_s(
                    ext.mul_s(A, ext.sub_s(ext.from_base_s(lgam), combo)), mu))
                sum_a = ext.add_s(sum_a, A)
            terms.append(ext.sub_s(ext.sub_s(S_next, S), sum_a))

    # gate terms
    alg = ExtAlg()
    max_constraints = max((g.num_constraints for g in common.gates), default=0)
    slots = [ext.ZERO] * max_constraints
    vars_ = EvalVars(wires, consts, [ext.from_base_s(h) for h in pi_hash])
    for gi, gate in enumerate(common.gates):
        filt = filt_of(gi)
        for t_idx, cval in enumerate(gate.eval(vars_, alg)):
            slots[t_idx] = ext.add_s(slots[t_idx], ext.mul_s(filt, cval))
    terms.extend(slots)

    for c in range(nc):
        lhs = ext.ZERO
        apow = ext.ONE
        alpha_e = ext.from_base_s(alphas[c])
        for t in terms:
            lhs = ext.add_s(lhs, ext.mul_s(apow, t))
            apow = ext.mul_s(apow, alpha_e)
        rhs = ext.ZERO
        for m in range(1 << fri_cfg.rate_bits):
            idx = c * (1 << fri_cfg.rate_bits) + m
            rhs = ext.add_s(rhs, ext.mul_s(ext.pow_s(zeta_pow_n, m),
                                           quotient[idx]))
        rhs = ext.mul_s(zh_zeta, rhs)
        require(ext.eq_s(lhs, rhs), f"constraint identity (challenge {c})")

    # ---- FRI ----
    g = gl.primitive_root_of_unity(common.degree_bits)
    zeta_next = ext.scalar_mul_s(zeta, g)
    batch0_open = [tuple(e) for e in (o.constants_sigmas + o.wires
                                      + o.zs_partial_products + o.quotient)]
    o0 = ext.ZERO
    for v in reversed(batch0_open):
        o0 = ext.add_s(ext.mul_s(o0, fri_alpha), v)
    o1 = ext.ZERO
    for v in reversed(zs_next):
        o1 = ext.add_s(ext.mul_s(o1, fri_alpha), v)
    alpha_b0 = ext.pow_s(fri_alpha, len(batch0_open))

    log_N = common.degree_bits + fri_cfg.rate_bits
    w_N = gl.primitive_root_of_unity(log_N)
    cs_count = sel_count + n_consts + nr
    nw = cfg.num_wires
    n_q = nc << fri_cfg.rate_bits
    r1_rows = list(range(nc))                 # rows opened at zeta*g
    if lki["has"]:
        r1_rows += [n_zb + c * pcc + lki["k"] for c in range(nc)]

    def combine_fn(idx, leaves):
        # Merkle leaves may carry zero padding past the logical column
        # count (merkle.py); truncate to the committed polynomial counts.
        cs_leaf = leaves[0][:cs_count]
        wires_leaf = leaves[1][:nw]
        zs_leaf = leaves[2][:n_zspp]
        q_leaf = leaves[3][:n_q]
        require(len(cs_leaf) == cs_count and len(wires_leaf) == nw
                and len(zs_leaf) == n_zspp and len(q_leaf) == n_q,
                "initial leaf widths")
        # idx is a bit-reversed domain index (fri/fri.py layout)
        x = gl.mul_s(COSET_SHIFT, pow(w_N, rev_bits(idx, log_N), gl.P))
        flat = list(cs_leaf) + list(wires_leaf) + list(zs_leaf) + list(q_leaf)
        r0 = ext.ZERO
        for v in reversed(flat):
            r0 = ext.add_s(ext.mul_s(r0, fri_alpha), ext.from_base_s(v))
        r1 = ext.ZERO
        for v in reversed([zs_leaf[i] for i in r1_rows]):
            r1 = ext.add_s(ext.mul_s(r1, fri_alpha), ext.from_base_s(v))
        x_e = ext.from_base_s(x)
        f0 = ext.mul_s(ext.sub_s(r0, o0), ext.inv_s(ext.sub_s(x_e, zeta)))
        f1 = ext.mul_s(ext.sub_s(r1, o1), ext.inv_s(ext.sub_s(x_e, zeta_next)))
        return ext.add_s(f0, ext.mul_s(alpha_b0, f1))

    initial_caps = [vd.cs_cap, proof.wires_cap, proof.zs_pp_cap,
                    proof.quotient_cap]
    fri_verify(proof.fri, common.degree_bits, fri_cfg, ch, COSET_SHIFT,
               initial_caps, combine_fn)
