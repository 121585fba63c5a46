"""In-circuit verification of a full proof (the recursive verifier).

Host copy of `plonky2_tpu/recursion/verifier.py` (plonky2's `verify_proof`
circuit; config 5 verifies four zkDSA proofs with it).  Every builder call
is made in the JAX module's order: row order decides the graph and the
proof bytes.  The transcript is replayed with the Poseidon sponge, so the
inner circuit must use Poseidon as both hashers and the outer one as its
in-circuit hasher (as in plonky2, whose KeccakGoldilocksConfig proofs are
not recursively verifiable); other configs raise, where the JAX module
asserts.

Design: the host verifier (prove/verifier.py + fri/fri.py) is the spec;
this module replays it over targets:

* challenges via `RecursiveChallenger` (same duplex schedule as the host
  `Challenger`, so the derived challenges match the prover's),
* the constraint identity at zeta via `CircuitAlg` (each inner gate's
  generic `eval` emitted as extension-gate rows — zero per-gate code),
* FRI: PoW check, query-index bit decomposition, in-circuit Merkle paths
  (`verify_merkle_proof_to_cap_circuit`), batched-opening combine by
  Horner (`ReducingGate` rows), fold consistency via `RandomAccessGate`
  selects, and per-step coset interpolation (`CosetInterpolationGate`).

Soundness note on index bits: a query challenge c is decomposed by
`split_le(c, 64)`; since sums of 64 bits wrap the field once, challenges
below 2^32-ish admit two decompositions.  This matches upstream plonky2's
recursive FRI behavior (`split_le` of the challenge) and costs < 2^-32 of
soundness per query.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import ext, gl
from ..hashes import poseidon
from ..ntt import COSET_SHIFT
from ..witness import NamedGenerator
from .challenger import RecursiveChallenger
from .circuit_alg import CircuitAlg
from .merkle import verify_merkle_proof_to_cap_circuit


# ------------------------------------------------------------------
# target containers
# ------------------------------------------------------------------

@dataclass
class FriInitialOpeningTarget:
    leaf_values: list        # base targets (padded leaf width)
    siblings: list           # list of 4-target digests


@dataclass
class FriQueryStepTarget:
    evals: list              # list of ext targets (arity entries)
    siblings: list


@dataclass
class FriQueryRoundTarget:
    initial: list            # per initial oracle
    steps: list


@dataclass
class FriProofTarget:
    commit_caps: list        # list[list[4-target digest]]
    query_rounds: list
    final_poly: list         # ext targets
    pow_witness: object


@dataclass
class ProofTarget:
    wires_cap: list
    zs_pp_cap: list
    quotient_cap: list
    # opening set (ext targets), same field order as prove/proof.py
    constants_sigmas: list
    wires: list
    zs_partial_products: list
    zs_next: list
    quotient: list
    fri: FriProofTarget
    public_inputs: list


def _padded_width(c: int) -> int:
    """Merkle leaf width after merkle.py's rate padding."""
    if c > poseidon.HASH_OUT and c % poseidon.RATE:
        return c + (poseidon.RATE - c % poseidon.RATE)
    return c


def _oracle_shapes(common):
    """(padded leaf widths, logical widths) of the 4 initial oracles."""
    cfg = common.config
    nc = cfg.num_challenges
    K = common.num_partial_products + 1
    cs_count = (len(common.selector_info.groups) + common.num_constants_polys
                + cfg.num_routed_wires)
    widths = [cs_count, cfg.num_wires, nc * K, nc << cfg.fri.rate_bits]
    return [_padded_width(w) for w in widths], widths


def add_virtual_proof_target(b, common) -> ProofTarget:
    """Allocate targets for every field of a proof of `common`'s shape."""
    cfg = common.config
    fri_cfg = cfg.fri
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    K = common.num_partial_products + 1
    n_bits = common.degree_bits
    N_bits = n_bits + fri_cfg.rate_bits
    cap_n = 1 << fri_cfg.cap_height

    def cap():
        return [b.add_virtual_targets(4) for _ in range(cap_n)]

    def exts(k):
        return [b.add_virtual_extension_target() for _ in range(k)]

    padded, widths = _oracle_shapes(common)
    arities = fri_cfg.reduction_arity_bits(n_bits)

    init_sibs = N_bits - fri_cfg.cap_height
    rounds = []
    for _ in range(fri_cfg.num_query_rounds):
        initial = [FriInitialOpeningTarget(
            leaf_values=b.add_virtual_targets(w),
            siblings=[b.add_virtual_targets(4) for _ in range(init_sibs)])
            for w in padded]
        steps = []
        cur_bits = N_bits
        for ab in arities:
            rows_bits = cur_bits - ab
            cap_i = min(fri_cfg.cap_height, rows_bits)
            steps.append(FriQueryStepTarget(
                evals=exts(1 << ab),
                siblings=[b.add_virtual_targets(4)
                          for _ in range(rows_bits - cap_i)]))
            cur_bits = rows_bits
        rounds.append(FriQueryRoundTarget(initial, steps))

    commit_caps = []
    cur_bits = N_bits
    for ab in arities:
        rows_bits = cur_bits - ab
        cap_i = min(fri_cfg.cap_height, rows_bits)
        commit_caps.append([b.add_virtual_targets(4)
                            for _ in range(1 << cap_i)])
        cur_bits = rows_bits

    final_len = 1 << (n_bits - sum(arities))
    fri_t = FriProofTarget(
        commit_caps=commit_caps,
        query_rounds=rounds,
        final_poly=exts(final_len),
        pow_witness=b.add_virtual_target(),
    )
    return ProofTarget(
        wires_cap=cap(), zs_pp_cap=cap(), quotient_cap=cap(),
        constants_sigmas=exts(widths[0]),
        wires=exts(cfg.num_wires),
        zs_partial_products=exts(nc * K),
        zs_next=exts(nc),
        quotient=exts(nc << fri_cfg.rate_bits),
        fri=fri_t,
        public_inputs=b.add_virtual_targets(common.num_public_inputs),
    )


def set_proof_witness(inputs: dict, pt: ProofTarget, proof) -> None:
    """Bind a host Proof's values onto the targets of `pt`."""
    def set_cap(ts, vs):
        for trow, vrow in zip(ts, vs):
            for t, v in zip(trow, vrow):
                inputs[t] = int(v)

    def set_exts(ts, vs):
        for t, v in zip(ts, vs):
            inputs[t[0]] = int(v[0])
            inputs[t[1]] = int(v[1])

    set_cap(pt.wires_cap, proof.wires_cap)
    set_cap(pt.zs_pp_cap, proof.zs_pp_cap)
    set_cap(pt.quotient_cap, proof.quotient_cap)
    o = proof.openings
    set_exts(pt.constants_sigmas, o.constants_sigmas)
    set_exts(pt.wires, o.wires)
    set_exts(pt.zs_partial_products, o.zs_partial_products)
    set_exts(pt.zs_next, o.zs_next)
    set_exts(pt.quotient, o.quotient)
    for t, v in zip(pt.public_inputs, proof.public_inputs):
        inputs[t] = int(v)
    f = proof.fri
    for ct, cv in zip(pt.fri.commit_caps, f.commit_caps):
        set_cap(ct, cv)
    set_exts(pt.fri.final_poly, f.final_poly)
    inputs[pt.fri.pow_witness] = int(f.pow_witness)
    for rt, rv in zip(pt.fri.query_rounds, f.query_rounds):
        for ot, ov in zip(rt.initial, rv.initial):
            for t, v in zip(ot.leaf_values, ov.leaf_values):
                inputs[t] = int(v)
            set_cap(ot.siblings, ov.siblings)
        for st, sv in zip(rt.steps, rv.steps):
            set_exts(st.evals, sv.evals)
            set_cap(st.siblings, sv.siblings)


# ------------------------------------------------------------------
# extension-target helpers
# ------------------------------------------------------------------

def _ext_from_base(b, t):
    return (t, b.zero())


def _inv_extension(b, a):
    """Hinted GF(p^2) inverse: witness computes a^-1, circuit checks
    a * inv == 1."""
    inv = b.add_virtual_extension_target()
    b.add_simple_generator(NamedGenerator(
        "ext_inv", {}, [a[0], a[1]], list(inv)))
    b.connect_extension(b.mul_extension(a, inv), b.one_extension())
    return inv


def _div_extension(b, num, den):
    return b.mul_extension(num, _inv_extension(b, den))


def _exp_ext_static(b, a, e: int):
    """a^e for a static exponent (square-and-multiply over mul_extension)."""
    result = None
    sq = a
    while e:
        if e & 1:
            result = sq if result is None else b.mul_extension(result, sq)
        e >>= 1
        if e:
            sq = b.mul_extension(sq, sq)
    return b.one_extension() if result is None else result


def _reduce_by_alpha(b, alpha_ext, terms_ext):
    """sum_i terms[i] * alpha^i over extension targets."""
    return b.reduce_with_powers_ext_circuit(alpha_ext,
                                            list(reversed(terms_ext)))


def _reduce_base_by_alpha(b, alpha_ext, terms_base):
    """sum_i terms[i] * alpha^i for base-field coefficient targets."""
    return b.reduce_with_powers_ext(alpha_ext, list(reversed(terms_base)))


# ------------------------------------------------------------------
# the verifier circuit
# ------------------------------------------------------------------

def verify_proof_circuit(b, vd, pt: ProofTarget) -> None:
    """Emit constraints asserting that `pt` is a valid proof for the
    circuit described by `vd` (a VerifierData: CommonData + cs cap).

    Mirrors prove/verifier.py line by line, over targets.  The inner
    circuit's verifier key (its constants/sigmas cap) enters the outer
    circuit as constants.
    """
    common = vd.common
    cfg = common.config
    fri_cfg = cfg.fri
    if not cfg.algebraic_hasher == b.config.algebraic_hasher == "poseidon":
        raise ValueError(
            "recursive verification replays the transcript with the Poseidon "
            "sponge; inner and outer configs must both use it")
    n = 1 << common.degree_bits
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    qf = cfg.max_quotient_degree_factor
    K = common.num_partial_products + 1
    N_bits = common.degree_bits + fri_cfg.rate_bits

    if len(pt.public_inputs) != common.num_public_inputs:
        raise ValueError(f"{len(pt.public_inputs)} public-input targets for "
                         f"{common.num_public_inputs} public inputs")
    pi_hash = b.hash_n_to_hash_no_pad(list(pt.public_inputs))

    cs_cap_const = [[b.constant(int(x)) for x in row] for row in vd.cs_cap]

    # ---- challenger replay ----
    ch = RecursiveChallenger(b)
    ch.observe_cap(cs_cap_const)
    ch.observe_elements(pi_hash)
    ch.observe_cap(pt.wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(pt.zs_pp_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(pt.quotient_cap)
    zeta = ch.get_ext_challenge()
    for e in (pt.constants_sigmas + pt.wires + pt.zs_partial_products
              + pt.zs_next + pt.quotient):
        ch.observe_ext(e)
    fri_alpha = ch.get_ext_challenge()

    # ---- constraint identity at zeta ----
    sel_count = len(common.selector_info.groups)
    sels = pt.constants_sigmas[:sel_count]
    consts = pt.constants_sigmas[sel_count:sel_count + common.num_constants_polys]
    sigmas = pt.constants_sigmas[sel_count + common.num_constants_polys:]
    one_e = b.one_extension()

    zeta_pow_n = zeta
    for _ in range(common.degree_bits):
        zeta_pow_n = b.mul_extension(zeta_pow_n, zeta_pow_n)
    zh_zeta = b.sub_extension(zeta_pow_n, one_e)
    l1_den = b.scalar_mul_ext(n, b.sub_extension(zeta, one_e))
    l1_zeta = b.mul_extension(zh_zeta, _inv_extension(b, l1_den))

    terms = []
    for c in range(nc):
        beta_e = _ext_from_base(b, betas[c])
        gamma_e = _ext_from_base(b, gammas[c])
        terms.append(b.mul_extension(
            l1_zeta, b.sub_extension(pt.zs_partial_products[c], one_e)))
        accs = ([pt.zs_partial_products[c]]
                + pt.zs_partial_products[nc + c * (K - 1):nc + (c + 1) * (K - 1)]
                + [pt.zs_next[c]])
        for m in range(K):
            pn = one_e
            pd_ = one_e
            for i in range(m * qf, min((m + 1) * qf, nr)):
                kx = b.mul_extension(beta_e,
                                     b.scalar_mul_ext(common.k_is[i], zeta))
                num_i = b.add_extension(b.add_extension(pt.wires[i], kx),
                                        gamma_e)
                den_i = b.add_extension(
                    b.add_extension(pt.wires[i],
                                    b.mul_extension(beta_e, sigmas[i])),
                    gamma_e)
                pn = b.mul_extension(pn, num_i)
                pd_ = b.mul_extension(pd_, den_i)
            terms.append(b.sub_extension(b.mul_extension(accs[m + 1], pd_),
                                         b.mul_extension(accs[m], pn)))

    # gate terms via the generic circuit algebra
    alg = CircuitAlg(b)
    sel_info = common.selector_info
    many = len(sel_info.groups) > 1
    max_constraints = max((g.num_constraints for g in common.gates), default=0)
    slots = [alg.zero] * max_constraints
    pi_hash_ext = [_ext_from_base(b, h) for h in pi_hash]
    from ..gates.base import EvalVars
    vars_ = EvalVars(list(pt.wires), list(consts), pi_hash_ext)
    for gi, gate in enumerate(common.gates):
        grp_idx = sel_info.gate_group[gi]
        s = sels[grp_idx]
        filt = one_e
        for other in sel_info.groups[grp_idx]:
            if other != gi:
                filt = b.mul_extension(
                    b.sub_extension(b.constant_extension((other, 0)), s), filt)
        if many:
            filt = b.mul_extension(
                b.sub_extension(b.constant_extension((sel_info.unused, 0)), s),
                filt)
        for t_idx, cval in enumerate(gate.eval(vars_, alg)):
            slots[t_idx] = b.add_extension(slots[t_idx],
                                           b.mul_extension(filt, cval))
    terms.extend(slots)

    rate = 1 << fri_cfg.rate_bits
    for c in range(nc):
        alpha_e = _ext_from_base(b, alphas[c])
        lhs = _reduce_by_alpha(b, alpha_e, terms)
        rhs = _reduce_by_alpha(b, zeta_pow_n,
                               pt.quotient[c * rate:(c + 1) * rate])
        rhs = b.mul_extension(zh_zeta, rhs)
        b.connect_extension(lhs, rhs)

    # ---- FRI ----
    g = gl.primitive_root_of_unity(common.degree_bits)
    zeta_next = b.scalar_mul_ext(g, zeta)
    batch0 = (pt.constants_sigmas + pt.wires + pt.zs_partial_products
              + pt.quotient)
    B0 = len(batch0)
    o0 = _reduce_by_alpha(b, fri_alpha, batch0)
    o1 = _reduce_by_alpha(b, fri_alpha, pt.zs_next)
    alpha_b0 = _exp_ext_static(b, fri_alpha, B0)

    arities = fri_cfg.reduction_arity_bits(common.degree_bits)
    fri_betas = []
    for cap_t in pt.fri.commit_caps:
        ch.observe_cap(cap_t)
        fri_betas.append(ch.get_ext_challenge())
    final_len = 1 << (common.degree_bits - sum(arities))
    if len(pt.fri.final_poly) != final_len:
        raise ValueError(f"final polynomial has {len(pt.fri.final_poly)} "
                         f"coefficients, expected {final_len}")
    for c_t in pt.fri.final_poly:
        ch.observe_ext(c_t)

    # proof of work: response must have pow_bits leading zeros
    ch.observe_element(pt.fri.pow_witness)
    response = ch.get_challenge()
    r_bits = b.split_le(response, 64)
    for i in range(64 - fri_cfg.proof_of_work_bits, 64):
        b.assert_zero(r_bits[i])

    padded_widths, widths = _oracle_shapes(common)
    cs_count, nw, n_zspp, n_q = widths
    initial_caps_t = [cs_cap_const, pt.wires_cap, pt.zs_pp_cap,
                      pt.quotient_cap]

    for qr in pt.fri.query_rounds:
        c = ch.get_challenge()
        bits64 = b.split_le(c, 64)
        idx_bits = bits64[:N_bits]

        # initial oracle Merkle proofs
        for opening, cap_t in zip(qr.initial, initial_caps_t):
            verify_merkle_proof_to_cap_circuit(
                b, opening.leaf_values, idx_bits, cap_t, opening.siblings)

        # batched-opening combine at x = shift * w_N^rev(idx): stored
        # indices are bit-reversed (fri/fri.py layout), so the exponent
        # reads the little-endian index bits in reversed order.
        w_N = gl.primitive_root_of_unity(N_bits)
        x = b.mul_const(COSET_SHIFT, b.exp_from_bits(
            b.constant(w_N), list(reversed(idx_bits))))
        x_e = _ext_from_base(b, x)
        flat = (qr.initial[0].leaf_values[:cs_count]
                + qr.initial[1].leaf_values[:nw]
                + qr.initial[2].leaf_values[:n_zspp]
                + qr.initial[3].leaf_values[:n_q])
        r0 = _reduce_base_by_alpha(b, fri_alpha, flat)
        r1 = _reduce_base_by_alpha(b, fri_alpha,
                                   qr.initial[2].leaf_values[:nc])
        f0 = _div_extension(b, b.sub_extension(r0, o0),
                            b.sub_extension(x_e, zeta))
        f1 = _div_extension(b, b.sub_extension(r1, o1),
                            b.sub_extension(x_e, zeta_next))
        old_eval = b.add_extension(f0, b.mul_extension(alpha_b0, f1))

        # fold steps
        bits = idx_bits
        cur_shift = COSET_SHIFT
        cur_N_bits = N_bits
        from ..ntt.ntt import _bitrev_perm
        for ab, beta_t, step, cap_t in zip(arities, fri_betas, qr.steps,
                                           pt.fri.commit_caps):
            rows_bits = cur_N_bits - ab
            # contiguous blocks: coset index j = high bits, slot = low bits
            pos_bits, j_bits = bits[:ab], bits[ab:]
            pos_idx = b.le_sum(pos_bits)
            sel0 = b.random_access(pos_idx, [e[0] for e in step.evals])
            sel1 = b.random_access(pos_idx, [e[1] for e in step.evals])
            b.connect(sel0, old_eval[0])
            b.connect(sel1, old_eval[1])
            leaf = [x_ for e in step.evals for x_ in e]
            verify_merkle_proof_to_cap_circuit(b, leaf, j_bits, cap_t,
                                               step.siblings)
            # x_j = shift * w^rev(j); block slot m holds the value at
            # x_j * w_a^rev_a(m) -> reorder the (static) eval targets so the
            # interpolation gate sees natural coset order
            w_cur = gl.primitive_root_of_unity(cur_N_bits)
            x_j = b.mul_const(cur_shift, b.exp_from_bits(
                b.constant(w_cur), list(reversed(j_bits))))
            rev_a = _bitrev_perm(ab)
            evals_nat = [step.evals[int(rev_a[k2])] for k2 in range(1 << ab)]
            old_eval = b.interpolate_coset(ab, x_j, evals_nat, beta_t)
            bits = j_bits
            cur_N_bits = rows_bits
            cur_shift = pow(cur_shift, 1 << ab, gl.P)

        # final polynomial check at the surviving point
        w_f = gl.primitive_root_of_unity(cur_N_bits)
        x_f = b.mul_const(cur_shift, b.exp_from_bits(
            b.constant(w_f), list(reversed(bits))))
        fin = _reduce_by_alpha(b, _ext_from_base(b, x_f),
                               list(pt.fri.final_poly))
        b.connect_extension(fin, old_eval)


def add_proof_verification(b, vd) -> ProofTarget:
    """Convenience: allocate targets, emit the verification constraints,
    return the ProofTarget; caller binds a concrete proof with
    `set_proof_witness`."""
    if vd.common.config.transcript_hasher != "poseidon":
        raise ValueError(
            "recursive verification requires the Poseidon transcript hasher")
    pt = add_virtual_proof_target(b, vd.common)
    verify_proof_circuit(b, vd, pt)
    return pt
