// Native witness kernels: Goldilocks arithmetic + Poseidon row engine.
//
// Host copy of plonky2_tpu/native/witness_kernels.cpp.  The host-side hot
// loops of witness generation run in C++ behind a ctypes boundary: the
// Poseidon permutation-with-checkpoints that fills a PoseidonGate row
// (gates/poseidon_gate.py), batched Goldilocks helpers, and the static
// witness tape's executor (witness/tape.py).
//
// Build: plonky2_tpu_torch/native/__init__.py compiles this with g++ -O3
// at first use into plonky2_tpu_torch/build/; a failed build raises.
//
// p = 2^64 - 2^32 + 1.  Reduction uses unsigned __int128.

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 EPS = 0xFFFFFFFFULL;   // 2^64 mod p

static inline u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += EPS;                // wrapped: + 2^64 mod p
    if (s >= P) s -= P;
    return s;
}

static inline u64 gl_mul(u64 a, u64 b) {
    u128 t = (u128)a * b;
    u64 lo = (u64)t, hi = (u64)(t >> 64);
    u64 hi_hi = hi >> 32, hi_lo = hi & EPS;
    u64 r = lo - hi_hi;
    if (lo < hi_hi) r -= EPS;           // borrow (wrapping)
    u64 c = hi_lo * EPS;
    r += c;
    if (r < c) r += EPS;
    if (r >= P) r -= P;
    return r;
}

static inline u64 gl_sbox(u64 x) {      // x^7
    u64 x2 = gl_mul(x, x);
    u64 x3 = gl_mul(x2, x);
    return gl_mul(gl_mul(x3, x3), x);
}

extern "C" {

// Poseidon row engine: for `count` rows, given inputs[count][12] and
// swap[count], write the full PoseidonGate aux/output wire values:
//   out[count][4 + 36 + 22 + 48 + 12] in wire order
//   (delta[4], full1 checkpoints r=1..3 [36], partial s-box lanes [22],
//    full2 checkpoints r=0..3 [48], outputs [12]).
// rc: [n_rounds][12] round constants; mds: [12][12] dense matrix
// (small-entry circulant in the default instantiation, but the dense form
// keeps this independent of that choice); n_full2 = 4, n_partial = 22.
void poseidon_rows(const u64* inputs, const u64* swaps, u64* out,
                   long count, const u64* rc, const u64* mds,
                   int n_full_half, int n_partial) {
    const int W = 12;
    for (long row = 0; row < count; ++row) {
        const u64* in = inputs + row * W;
        u64* o = out + row * (4 + 3 * W + n_partial + 4 * W + W);
        u64 s[12], tmp[12];
        u64 swap = swaps[row];
        // delta_i = swap * (in[4+i] - in[i]);  swapped state
        u64 delta[4];
        for (int i = 0; i < 4; ++i) {
            u64 a = in[4 + i] % P, b = in[i] % P;
            u64 diff = a >= b ? a - b : a + P - b;
            delta[i] = swap ? gl_mul(swap % P, diff) : 0;
            o[i] = delta[i];
        }
        for (int i = 0; i < 4; ++i) s[i] = gl_add(in[i] % P, delta[i]);
        for (int i = 0; i < 4; ++i) {
            u64 a = in[4 + i] % P, d = delta[i];
            s[4 + i] = a >= d ? a - d : a + P - d;
        }
        for (int i = 8; i < 12; ++i) s[i] = in[i] % P;

        int r = 0;
        u64* chk1 = o + 4;                         // 3*12 checkpoints
        u64* part = chk1 + 3 * W;                  // n_partial lanes
        u64* chk2 = part + n_partial;              // 4*12 checkpoints
        u64* outw = chk2 + 4 * W;                  // 12 outputs

        auto mds_layer = [&](u64* st) {
            for (int i = 0; i < W; ++i) {
                u128 acc = 0;
                const u64* mrow = mds + i * W;
                for (int j = 0; j < W; ++j)
                    acc += (u128)mrow[j] * st[j];
                tmp[i] = (u64)(acc % P);
            }
            std::memcpy(st, tmp, sizeof(tmp));
        };

        for (int fr = 0; fr < n_full_half; ++fr) {
            for (int i = 0; i < W; ++i) s[i] = gl_add(s[i], rc[r * W + i]);
            if (fr > 0)
                for (int i = 0; i < W; ++i) chk1[(fr - 1) * W + i] = s[i];
            for (int i = 0; i < W; ++i) s[i] = gl_sbox(s[i]);
            mds_layer(s);
            ++r;
        }
        for (int k = 0; k < n_partial; ++k) {
            for (int i = 0; i < W; ++i) s[i] = gl_add(s[i], rc[r * W + i]);
            part[k] = s[0];
            s[0] = gl_sbox(s[0]);
            mds_layer(s);
            ++r;
        }
        for (int fr = 0; fr < n_full_half; ++fr) {
            for (int i = 0; i < W; ++i) s[i] = gl_add(s[i], rc[r * W + i]);
            for (int i = 0; i < W; ++i) chk2[fr * W + i] = s[i];
            for (int i = 0; i < W; ++i) s[i] = gl_sbox(s[i]);
            mds_layer(s);
            ++r;
        }
        for (int i = 0; i < W; ++i) outw[i] = s[i];
    }
}

// Batched Goldilocks modmul (self-test / host helpers).
void gl_mul_arr(const u64* a, const u64* b, u64* out, long n) {
    for (long i = 0; i < n; ++i) out[i] = gl_mul(a[i] % P, b[i] % P);
}

}  // extern "C"

// ------------------------------------------------------------------
// Static witness tape executor (witness/tape.py).
//
// The generator DAG is toposorted once per circuit into a flat opcode
// tape; this loop executes the typed ops (u32 arithmetic, Goldilocks
// mul-add, Poseidon rows, constant fills, base decompositions) directly
// against the value array, returning to Python only at OP_PY escapes
// (rare gadget hints).  Replaces the per-generator Python dataflow
// scheduler on the hot path.
// ------------------------------------------------------------------

enum TapeOp {
    OP_PY = 0,
    OP_U32MULADD = 1,    // deps x,y,z           -> lo, hi of x*y+z
    OP_U32ADDMANY = 2,   // deps a0..an-1        -> lo, hi of sum
    OP_U32SUB = 3,       // deps x,y,borrow_in   -> result, borrow_out
    OP_CMP = 4,          // deps a,b             -> res, e, e limbs (base 4)
    OP_ARITH = 5,        // deps x,y,z; upool c0,c1 -> c0*x*y + c1*z mod p
    OP_CONSTS = 6,       // upool values         -> outs verbatim
    OP_POSEIDON = 7,     // deps in0..11, swap   -> out0..11
    OP_BASESUM = 8,      // dep s; upool base    -> limbs of s in base
    OP_RANDACC = 9,      // deps idx, items...   -> idx bits, items[idx]
    OP_INTERLEAVE = 10,  // dep x (u32)          -> x_interleaved, 32 bits
    OP_UNINTER = 11,     // dep x; upool base    -> evens, odds, 64 bits
    OP_ARITH_EXT = 12,   // deps m0,m1,ad (2 ea); upool c0,c1 -> out (2)
    OP_MUL_EXT = 13,     // deps m0,m1 (2 ea); upool c0       -> out (2)
    OP_REDUCE = 14,      // deps alpha,acc (2 ea), base coeffs -> accs, out
    OP_REDUCE_EXT = 15,  // deps alpha,acc (2 ea), ext coeffs  -> accs, out
};

static const u64 EXT_W = 7;   // GF(p^2) = F_p[X]/(X^2 - 7) (field/ext.py)

static inline void ext_mul2(u64 a0, u64 a1, u64 b0, u64 b1,
                            u64* r0, u64* r1) {
    *r0 = gl_add(gl_mul(a0, b0), gl_mul(EXT_W, gl_mul(a1, b1)));
    *r1 = gl_add(gl_mul(a0, b1), gl_mul(a1, b0));
}

static inline bool tape_put(u64* values, uint8_t* has, int32_t slot, u64 v,
                            long* err_slot) {
    if (has[slot]) {
        if (values[slot] != v) { *err_slot = slot; return false; }
        return true;
    }
    values[slot] = v;
    has[slot] = 1;
    return true;
}

static void poseidon_out12(u64* s, u64 swap, const u64* rc, const u64* mds,
                           int n_full_half, int n_partial) {
    const int W = 12;
    u64 tmp[12];
    u64 delta[4];
    for (int i = 0; i < 4; ++i) {
        u64 a = s[4 + i], b = s[i];
        u64 diff = a >= b ? a - b : a + P - b;
        delta[i] = swap ? gl_mul(swap, diff) : 0;
    }
    for (int i = 0; i < 4; ++i) {
        u64 a = s[4 + i], d = delta[i];
        s[i] = gl_add(s[i], delta[i]);
        s[4 + i] = a >= d ? a - d : a + P - d;
    }
    auto mds_layer = [&]() {
        for (int i = 0; i < W; ++i) {
            u128 acc = 0;
            const u64* mrow = mds + i * W;
            for (int j = 0; j < W; ++j) acc += (u128)mrow[j] * s[j];
            tmp[i] = (u64)(acc % P);
        }
        std::memcpy(s, tmp, sizeof(tmp));
    };
    int r = 0;
    for (int fr = 0; fr < n_full_half; ++fr, ++r) {
        for (int i = 0; i < W; ++i) s[i] = gl_sbox(gl_add(s[i], rc[r * W + i]));
        mds_layer();
    }
    for (int k = 0; k < n_partial; ++k, ++r) {
        for (int i = 0; i < W; ++i) s[i] = gl_add(s[i], rc[r * W + i]);
        s[0] = gl_sbox(s[0]);
        mds_layer();
    }
    for (int fr = 0; fr < n_full_half; ++fr, ++r) {
        for (int i = 0; i < W; ++i) s[i] = gl_sbox(gl_add(s[i], rc[r * W + i]));
        mds_layer();
    }
}

extern "C" {

// Returns: index of an OP_PY entry to run in Python (caller resumes at
// index+1), -1 when the tape is exhausted, -2 on a write conflict
// (*err_slot holds the slot).  dep_off/out_off are prefix arrays of
// length n_ops+1 into dep_slots/out_slots.
long tape_run(u64* values, uint8_t* has,
              const int32_t* code, const int64_t* uoff, const u64* upool,
              const int32_t* dep_off, const int32_t* dep_slots,
              const int32_t* out_off, const int32_t* out_slots,
              long n_ops, long start,
              const u64* rc, const u64* mds, int n_full_half, int n_partial,
              long* err_slot) {
    for (long i = start; i < n_ops; ++i) {
        const int32_t* d = dep_slots + dep_off[i];
        const int32_t* o = out_slots + out_off[i];
        int nd = dep_off[i + 1] - dep_off[i];
        int no = out_off[i + 1] - out_off[i];
        switch (code[i]) {
        case OP_PY:
            return i;
        case OP_U32MULADD: {
            u64 r = values[d[0]] * values[d[1]] + values[d[2]];
            if (!tape_put(values, has, o[0], r & 0xFFFFFFFFULL, err_slot) ||
                !tape_put(values, has, o[1], r >> 32, err_slot)) return -2;
            break;
        }
        case OP_U32ADDMANY: {
            u64 s = 0;
            for (int j = 0; j < nd; ++j) s += values[d[j]];
            if (!tape_put(values, has, o[0], s & 0xFFFFFFFFULL, err_slot) ||
                !tape_put(values, has, o[1], s >> 32, err_slot)) return -2;
            break;
        }
        case OP_U32SUB: {
            int64_t df = (int64_t)values[d[0]] - (int64_t)values[d[1]]
                         - (int64_t)values[d[2]];
            u64 bout = df < 0 ? 1 : 0;
            u64 res = (u64)(df + (int64_t)(bout << 32));
            if (!tape_put(values, has, o[0], res, err_slot) ||
                !tape_put(values, has, o[1], bout, err_slot)) return -2;
            break;
        }
        case OP_CMP: {
            u64 a = values[d[0]], b = values[d[1]];
            u64 res = a <= b ? 1 : 0;
            u64 e = res ? b - a : a - b - 1;
            if (!tape_put(values, has, o[0], res, err_slot) ||
                !tape_put(values, has, o[1], e, err_slot)) return -2;
            for (int j = 0; j < no - 2; ++j)
                if (!tape_put(values, has, o[2 + j], (e >> (2 * j)) & 3,
                              err_slot)) return -2;
            break;
        }
        case OP_ARITH: {
            const u64* c = upool + uoff[i];
            u64 r = gl_add(gl_mul(gl_mul(c[0], values[d[0]]), values[d[1]]),
                           gl_mul(c[1], values[d[2]]));
            if (!tape_put(values, has, o[0], r, err_slot)) return -2;
            break;
        }
        case OP_CONSTS: {
            const u64* c = upool + uoff[i];
            for (int j = 0; j < no; ++j)
                if (!tape_put(values, has, o[j], c[j], err_slot)) return -2;
            break;
        }
        case OP_POSEIDON: {
            u64 s[12];
            for (int j = 0; j < 12; ++j) s[j] = values[d[j]];
            poseidon_out12(s, values[d[12]], rc, mds, n_full_half, n_partial);
            for (int j = 0; j < 12; ++j)
                if (!tape_put(values, has, o[j], s[j], err_slot)) return -2;
            break;
        }
        case OP_BASESUM: {
            u64 base = upool[uoff[i]];
            u64 s = values[d[0]];
            for (int j = 0; j < no; ++j) {
                if (!tape_put(values, has, o[j], s % base, err_slot))
                    return -2;
                s /= base;
            }
            break;
        }
        case OP_RANDACC: {
            u64 idx = values[d[0]];
            int bits = no - 1;
            for (int j = 0; j < bits; ++j)
                if (!tape_put(values, has, o[j], (idx >> j) & 1, err_slot))
                    return -2;
            if ((long)idx >= nd - 1) { *err_slot = -1; return -2; }
            if (!tape_put(values, has, o[bits], values[d[1 + idx]], err_slot))
                return -2;
            break;
        }
        case OP_ARITH_EXT: {
            const u64* c = upool + uoff[i];
            u64 p0, p1;
            ext_mul2(values[d[0]], values[d[1]], values[d[2]], values[d[3]],
                     &p0, &p1);
            u64 r0 = gl_add(gl_mul(c[0], p0), gl_mul(c[1], values[d[4]]));
            u64 r1 = gl_add(gl_mul(c[0], p1), gl_mul(c[1], values[d[5]]));
            if (!tape_put(values, has, o[0], r0, err_slot) ||
                !tape_put(values, has, o[1], r1, err_slot)) return -2;
            break;
        }
        case OP_MUL_EXT: {
            const u64* c = upool + uoff[i];
            u64 p0, p1;
            ext_mul2(values[d[0]], values[d[1]], values[d[2]], values[d[3]],
                     &p0, &p1);
            if (!tape_put(values, has, o[0], gl_mul(c[0], p0), err_slot) ||
                !tape_put(values, has, o[1], gl_mul(c[0], p1), err_slot))
                return -2;
            break;
        }
        case OP_REDUCE:
        case OP_REDUCE_EXT: {
            bool ext = code[i] == OP_REDUCE_EXT;
            u64 al0 = values[d[0]], al1 = values[d[1]];
            u64 a0 = values[d[2]], a1 = values[d[3]];
            int steps = ext ? (nd - 4) / 2 : nd - 4;
            int oi = 0;
            for (int j = 0; j < steps; ++j) {
                u64 t0, t1;
                ext_mul2(a0, a1, al0, al1, &t0, &t1);
                if (ext) {
                    a0 = gl_add(t0, values[d[4 + 2 * j]] % P);
                    a1 = gl_add(t1, values[d[5 + 2 * j]] % P);
                } else {
                    a0 = gl_add(t0, values[d[4 + j]] % P);
                    a1 = t1;
                }
                if (j < steps - 1) {
                    if (!tape_put(values, has, o[oi++], a0, err_slot) ||
                        !tape_put(values, has, o[oi++], a1, err_slot))
                        return -2;
                }
            }
            if (!tape_put(values, has, o[oi++], a0, err_slot) ||
                !tape_put(values, has, o[oi], a1, err_slot)) return -2;
            break;
        }
        case OP_INTERLEAVE: {
            u64 x = values[d[0]];
            u64 il = 0;
            for (int j = 0; j < 32; ++j) {
                u64 b = (x >> j) & 1;
                il |= b << (2 * j);
                if (!tape_put(values, has, o[1 + j], b, err_slot)) return -2;
            }
            if (!tape_put(values, has, o[0], il, err_slot)) return -2;
            break;
        }
        case OP_UNINTER: {
            u64 x = values[d[0]], B = upool[uoff[i]];
            for (int j = 0; j < 64; ++j)
                if (!tape_put(values, has, o[2 + j], (x >> j) & 1, err_slot))
                    return -2;
            u64 ev = 0, od = 0, pw = 1;
            for (int j = 0; j < 32; ++j) {
                ev += ((x >> (2 * j)) & 1) * pw;
                od += ((x >> (2 * j + 1)) & 1) * pw;
                pw *= B;
            }
            if (!tape_put(values, has, o[0], ev, err_slot) ||
                !tape_put(values, has, o[1], od, err_slot)) return -2;
            break;
        }
        default:
            *err_slot = -1;
            return -2;
        }
    }
    return -1;
}

}  // extern "C"
