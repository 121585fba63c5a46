"""FRI low-degree commitment on torch tensors, and its host verifier.

Counterpart of `plonky2_tpu/fri/fri.py`.  Commit phase: Merkle-commit
the current layer's folding cosets, draw beta, fold by arity 2^a (a
batched size-a iNTT of every coset plus a Horner evaluation at beta/x_j).
Then the final polynomial in the clear, the proof-of-work grind (one
batched permutation of the transcript hasher per chunk of candidate
witnesses: kernel K1 on the card under Poseidon, plain torch under
Keccak), and the query openings.  The layer trees and the grind hash with
the challenger's hasher, the config's transcript hasher.
`fri_verify` replays the transcript and checks each query on the host, in
Python ints; it touches no device.

On a device mesh (`parallel.Mesh`) `fri_prove` takes the composite as the
mesh's row shards: the first layer's tree (`ShardedMerkleTree`) and fold
run per shard, since an arity block is contiguous and lies in one shard
while N/d >= 2^arity; the folded layer is gathered on the mesh's first
device, where the later layers, the final polynomial, the grind and the
query gathers run.

Layout (plonky2's): every LDE is stored in BIT-REVERSED domain order —
index r holds the value at shift * w^rev(r) — so an arity-2^a folding
coset is the contiguous block [j*2^a, (j+1)*2^a), block j of layer L folds
to index j of layer L+1, and a query's coset index is r >> a.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..field import ext, gl
from ..merkle import MerkleTree, ShardedMerkleTree, verify_merkle_proof_s
from ..ntt.ntt import _bitrev_perm, host_powers, intt, intt_from_rev
from ..transcript import Challenger
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 28
    arity_bits: int = 4
    final_poly_bits: int = 5

    def reduction_arity_bits(self, degree_bits: int) -> list[int]:
        out = []
        d = degree_bits
        while d > self.final_poly_bits:
            a = min(self.arity_bits, d - self.final_poly_bits)
            out.append(a)
            d -= a
        return out


@dataclass
class FriInitialOpening:
    leaf_values: list  # list[int]
    siblings: list     # list[list[int]]


@dataclass
class FriQueryStep:
    evals: list        # list[(c0, c1)] — the arity coset values
    siblings: list


@dataclass
class FriQueryRound:
    initial: list      # list[FriInitialOpening], one per initial oracle
    steps: list        # list[FriQueryStep]


@dataclass
class FriProof:
    commit_caps: list  # list[list[4-elem digest]]
    query_rounds: list
    final_poly: list   # list[(c0, c1)] extension coefficients
    pow_witness: int
    query_indices: list = field(default_factory=list)  # derived; kept for debugging


# ------------------------------------------------------------------
# Device helpers
# ------------------------------------------------------------------

def _intt_ext(values):
    """iNTT over the extension: values [..., n, 2] -> coeffs [..., n, 2]."""
    return intt(values.movedim(-1, 0)).movedim(0, -1)


def _intt_ext_from_rev(values_rev):
    """Like _intt_ext but the evaluations on dim -2 are bit-reversed."""
    return intt_from_rev(values_rev.movedim(-1, 0)).movedim(0, -1)


def _fold(values, beta, shift: int, arity_bits: int):
    """One FRI fold by arity a = 2^arity_bits: [N, 2] ext values in
    BIT-REVERSED order on shift*<w_N> -> [N/a, 2] bit-reversed values on
    shift^a * <w_{N/a}>.

    Folding coset j is the block values[j*a:(j+1)*a], holding the natural
    coset {x_j * w_a^k} in rev_a(k) order: iNTT_a of each block, then
    Horner at beta/x_j with x_j = shift * w_N^rev(j)."""
    xinv = _fold_xinv(values.shape[0], shift, arity_bits)
    return _fold_blocks(values, _fold_twist(beta, xinv, values.device), arity_bits)


def _fold_xinv(N: int, shift: int, arity_bits: int) -> np.ndarray:
    """1/x_j for each folding coset j < N/a, as uint64 (host)."""
    rows = N >> arity_bits
    w_inv = gl.inv_s(gl.primitive_root_of_unity(N.bit_length() - 1))
    xinv = host_powers(w_inv, rows)[_bitrev_perm(rows.bit_length() - 1)]
    return (xinv.astype(object) * gl.inv_s(shift) % gl.P).astype(np.uint64)


def _fold_twist(beta, xinv: np.ndarray, device):
    """beta/x_j for the cosets of `xinv` -> [len(xinv), 2] on `device`."""
    return ext.mul_base(ext.scalar(beta, device).expand(len(xinv), 2),
                        gl.to_tensor(xinv, device))


def _fold_blocks(values, t, arity_bits: int):
    """Fold the arity blocks of values [rows * a, 2] at their twists t
    [rows, 2] -> [rows, 2]."""
    a = 1 << arity_bits
    coeffs = _intt_ext_from_rev(values.reshape(-1, a, 2))        # [rows, a, 2]
    acc = coeffs[:, a - 1, :]
    for k in range(a - 2, -1, -1):
        acc = ext.add(ext.mul(acc, t), coeffs[:, k, :])
    return acc


# ------------------------------------------------------------------
# Proof-of-work grind (device)
# ------------------------------------------------------------------

def _grind_kernel(state_row, lo: int, batch: int, pos: int, pow_bits: int,
                  hasher):
    """Candidates lo .. lo+batch-1 -> (found, first hit offset): permute
    every candidate state at once, test the last rate lane's top pow_bits
    bits (an unsigned compare), return the first hit."""
    device = state_row.device
    st = state_row[:, None].expand(hasher.WIDTH, batch).clone()
    st[pos] = lo + torch.arange(batch, dtype=gl.DTYPE, device=device)
    out = hasher.permute_cols(st)[hasher.RATE - 1]
    # out < 2^(64 - pow_bits) as u64: the top pow_bits bits are zero
    ok = ((out >> (64 - pow_bits)) & ((1 << pow_bits) - 1)) == 0
    hit = int(torch.argmax(ok.to(torch.uint8)).item())
    return bool(ok[hit].item()), hit


def grind(challenger: Challenger, pow_bits: int, batch: int | None = None,
          max_batches: int = 4096, device=DEFAULT_DEVICE) -> int:
    """The smallest w such that observe(w); get_challenge() has >= pow_bits
    leading zero bits.  Chunks are scanned in order and the first hit of
    the first chunk that has one is returned, so the witness does not
    depend on the batch size."""
    if not 1 <= pow_bits <= 63:
        raise ValueError(f"proof_of_work_bits must be in [1, 63], got {pow_bits}")
    if batch is None:
        batch = max(1 << 12, 16 << pow_bits)
    buf = challenger.input_buffer
    state = list(challenger.sponge_state)
    state[: len(buf)] = buf
    pos = len(buf)
    state_row = gl.to_tensor(state, resolve_device(device))
    for chunk in range(max_batches):
        found, hit = _grind_kernel(state_row, chunk * batch, batch, pos,
                                   pow_bits, challenger.hasher)
        if found:
            return chunk * batch + hit
    raise RuntimeError("PoW grind exhausted candidate space")


# ------------------------------------------------------------------
# Prover
# ------------------------------------------------------------------

def _layer_leaves(values, a: int):
    """Leaf j = the contiguous arity block j, flattened (c0, c1) pairs, in
    column layout [2a, rows] for build_cols."""
    rows = values.shape[0] // a
    return values.reshape(rows, a, 2).permute(1, 2, 0).reshape(2 * a, rows)


def fri_prove(values, degree_bits: int, config: FriConfig,
              challenger: Challenger, shift: int,
              initial_trees: list, mesh=None) -> FriProof:
    """values: [N, 2] ext composite over the LDE coset in BIT-REVERSED
    order, N = 2^(degree_bits + rate_bits), or with `mesh` its list of row
    shards.  initial_trees: the committed oracles (`MerkleTree` or
    `ShardedMerkleTree`) whose openings every query round includes."""
    arities = config.reduction_arity_bits(degree_bits)
    if mesh is None:
        N, device = values.shape[0], values.device
    else:
        N, device = sum(v.shape[0] for v in values), mesh.devices[0]
        if not arities or values[0].shape[0] < 1 << arities[0]:
            values = mesh.gather(values, dim=0)      # an arity block spans shards
    if N != 1 << (degree_bits + config.rate_bits):
        raise ValueError(f"composite has {N} points, want "
                         f"2^{degree_bits + config.rate_bits}")

    from ..utils import timed_span

    cur = values
    cur_shift = shift
    layer_trees: list = []
    with timed_span("FRI commit/fold layers"):
        for ab in arities:
            a = 1 << ab
            sharded = isinstance(cur, list)
            Nc = N if sharded else cur.shape[0]
            cap_height = min(config.cap_height, (Nc // a).bit_length() - 1)
            if sharded:
                tree = ShardedMerkleTree.build_cols(
                    mesh, [_layer_leaves(c, a) for c in cur], cap_height,
                    challenger.hasher)
            else:
                tree = MerkleTree.build_cols(_layer_leaves(cur, a), cap_height,
                                             challenger.hasher)
            layer_trees.append(tree)
            challenger.observe_cap(tree.cap_host())
            beta = challenger.get_ext_challenge()
            if sharded:
                # each shard folds its own blocks at their twists
                xinv = _fold_xinv(Nc, cur_shift, ab)
                w = len(xinv) // mesh.size
                cur = mesh.gather([
                    _fold_blocks(c, _fold_twist(beta, xinv[j * w:(j + 1) * w], c.device),
                                 ab) for j, c in enumerate(cur)], dim=0)
            else:
                cur = _fold(cur, beta, cur_shift, ab)
            cur_shift = pow(cur_shift, a, gl.P)

    with timed_span("FRI final poly"):
        Nf = cur.shape[0]
        q_coeffs = _intt_ext_from_rev(cur)                      # coeffs of f(shift*y)
        sinv_pows = gl.powers(gl.inv_s(cur_shift), Nf, cur.device)
        f_coeffs = gl.from_tensor(ext.mul_base(q_coeffs, sinv_pows))
        final_len = 1 << (degree_bits - sum(arities))
        final_poly = [(int(f_coeffs[k, 0]), int(f_coeffs[k, 1]))
                      for k in range(final_len)]
        for c in final_poly:
            challenger.observe_ext(c)

    with timed_span("FRI PoW grind"):
        pow_witness = grind(challenger, config.proof_of_work_bits, device=device)
        challenger.observe_element(pow_witness)
        response = challenger.get_challenge()
        if response >= 1 << (64 - config.proof_of_work_bits):
            raise RuntimeError("PoW witness does not meet the target")

    # Query rounds: one batched gather per tree, one host transfer each.
    with timed_span("FRI query openings (batched gather)"):
        query_indices = [challenger.get_challenge() % N
                         for _ in range(config.num_query_rounds)]
        idx_arr = np.asarray(query_indices, dtype=np.int64)
        initial_data = [t.open_many(idx_arr) for t in initial_trees]
        layer_data = []
        cur_idx = idx_arr
        for ab, tree in zip(arities, layer_trees):
            cur_idx = cur_idx >> ab          # contiguous blocks: high bits
            layer_data.append(tree.open_many(cur_idx))

    query_rounds = []
    for q in range(len(query_indices)):
        initial = [FriInitialOpening([int(x) for x in lv[q]],
                                     [[int(x) for x in s] for s in sib[q]])
                   for lv, sib in initial_data]
        steps = []
        for ab, (lv, sib) in zip(arities, layer_data):
            row = lv[q]
            evals = [(int(row[2 * k]), int(row[2 * k + 1])) for k in range(1 << ab)]
            steps.append(FriQueryStep(evals, [[int(x) for x in s] for s in sib[q]]))
        query_rounds.append(FriQueryRound(initial, steps))

    return FriProof(
        commit_caps=[t.cap_host() for t in layer_trees],
        query_rounds=query_rounds,
        final_poly=final_poly,
        pow_witness=pow_witness,
        query_indices=query_indices,
    )


# ------------------------------------------------------------------
# Verifier (host scalar)
# ------------------------------------------------------------------

def require(ok: bool, what: str) -> None:
    """The verifier's check: a failed one rejects the proof."""
    if not ok:
        raise ValueError(f"invalid proof: {what}")


def rev_bits(i: int, bits: int) -> int:
    """Bit reversal of one index: entry i of `_bitrev_perm(bits)`."""
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _interpolate_coset_s(points, values, beta):
    """Lagrange-interpolate {(points[k] base, values[k] ext)} and evaluate at
    beta (ext).  O(a^2), verifier-sized."""
    a = len(points)
    acc = ext.ZERO
    for k in range(a):
        num = ext.ONE
        den = 1
        for m in range(a):
            if m == k:
                continue
            num = ext.mul_s(num, ext.sub_s(beta, ext.from_base_s(points[m])))
            den = gl.mul_s(den, gl.sub_s(points[k], points[m]))
        term = ext.mul_s(values[k], ext.scalar_mul_s(num, gl.inv_s(den)))
        acc = ext.add_s(acc, term)
    return acc


def fri_verify(proof: FriProof, degree_bits: int, config: FriConfig,
               challenger: Challenger, shift: int,
               initial_caps: list, combine_fn) -> None:
    """Raises ValueError on any failed check.

    combine_fn(index, initial_leaf_values: list[list[int]]) -> ext tuple:
    recomputes the composite value at BIT-REVERSED domain index `index`
    (the point is shift * w^rev(index)) from the opened initial-oracle
    leaves."""
    N = 1 << (degree_bits + config.rate_bits)
    arities = config.reduction_arity_bits(degree_bits)
    require(len(proof.commit_caps) == len(arities), "FRI layer count")

    betas = []
    for cap in proof.commit_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_ext_challenge())
    final_len = 1 << (degree_bits - sum(arities))
    require(len(proof.final_poly) == final_len, "final polynomial length")
    for c in proof.final_poly:
        challenger.observe_ext(c)

    challenger.observe_element(proof.pow_witness)
    response = challenger.get_challenge()
    require(response < (1 << (64 - config.proof_of_work_bits)), "PoW check")

    query_indices = [challenger.get_challenge() % N
                     for _ in range(config.num_query_rounds)]
    require(len(proof.query_rounds) == len(query_indices), "query count")

    for idx, qr in zip(query_indices, proof.query_rounds):
        require(len(qr.initial) == len(initial_caps), "initial oracle count")
        for opening, cap in zip(qr.initial, initial_caps):
            require(verify_merkle_proof_s(opening.leaf_values, idx, cap,
                                          opening.siblings, challenger.hasher),
                    "initial Merkle proof")
        old_eval = combine_fn(idx, [o.leaf_values for o in qr.initial])

        cur_N, cur_i, cur_shift = N, idx, shift
        for (ab, beta, step, cap) in zip(arities, betas, qr.steps,
                                         proof.commit_caps):
            a = 1 << ab
            rows = cur_N // a
            j = cur_i >> ab              # contiguous block: high bits
            pos = cur_i & (a - 1)        # slot within block (rev_a order)
            require(len(step.evals) == a
                    and tuple(step.evals[pos]) == tuple(old_eval),
                    "fold consistency")
            leaf = [x for e in step.evals for x in e]
            require(verify_merkle_proof_s(leaf, j, cap, step.siblings,
                                          challenger.hasher),
                    "layer Merkle proof")
            # block slot m holds the value at x_j * w_a^{rev_a(m)},
            # x_j = shift * w_N^{rev_rows(j)}
            w_N = gl.primitive_root_of_unity(cur_N.bit_length() - 1)
            x_j = gl.mul_s(cur_shift, pow(w_N, rev_bits(j, rows.bit_length() - 1),
                                          gl.P))
            w_a = gl.primitive_root_of_unity(ab)
            pts = [gl.mul_s(x_j, pow(w_a, rev_bits(m, ab), gl.P))
                   for m in range(a)]
            vals = [tuple(e) for e in step.evals]
            old_eval = _interpolate_coset_s(pts, vals, beta)
            cur_N, cur_i, cur_shift = rows, j, pow(cur_shift, a, gl.P)

        # Final polynomial check at the surviving point.
        bits_f = cur_N.bit_length() - 1
        w_f = gl.primitive_root_of_unity(bits_f)
        x = gl.mul_s(cur_shift, pow(w_f, rev_bits(cur_i, bits_f), gl.P))
        acc = ext.ZERO
        for c in reversed(proof.final_poly):
            acc = ext.add_s(ext.mul_s(acc, ext.from_base_s(x)), tuple(c))
        require(tuple(acc) == tuple(old_eval), "final polynomial check")
