// Kernel K1: the Poseidon permutation (width 12, 4 + 22 + 4 rounds, x^7
// S-box) on a lanes-first batch of states, [12, B] row-major.
//
// Replaces plonky2_tpu/hashes/pallas_poseidon.py `permute_cols_pallas` (its
// kernel body in `_build`), which keeps a [12, 1024] block in VMEM as u32
// (hi, lo) planes for all 30 rounds and runs every round's dense MDS layer.
//
// What bounds it on an H100: integer instructions, and the latency of the
// chains they form.  Hopper has no 64-bit multiplier: a 64 x 64 -> 128-bit
// product is a chain of 32-bit multiply-adds (IMAD.WIDE.U32 and its carry
// forms), and a reduction mod p about as many adds and selects again.  The
// state (96 bytes in, 96 bytes out) is read and written once, so memory is
// far from the limit.  Each thread runs one permutation, a long dependent
// chain, so the SM needs many warps in flight to hide the latency:
// registers, not arithmetic alone, set the speed.
//
// What the design does about it:
// * Partial rounds in plonky2's fast form, from tables derived on the host
//   (`hashes/poseidon.py` `fast_partial_tables`): the round constants are
//   pushed back through the MDS matrix and the matrix is factored, so a
//   round is its S-box, one scalar add and 23 products (one 12-term dot
//   product for lane 0, 11 multiply-adds for lanes 1-11) instead of a
//   dense 12 x 12 layer; one 11 x 11 layer comes first.  Exact for any MDS
//   matrix.
// * The 8 full rounds keep the dense layer.  With plonky2's small-entry
//   matrix (every entry < 2^20, stored as uint32_t) a row is 24
//   IMAD.WIDE.U32 on the 32-bit halves of the state, accumulated exactly in
//   u64 and reduced once; any other matrix takes 12-term dot products.
// * Lazy arithmetic (goldilocks.cuh): values stay below 2^64 but not
//   necessarily below p inside the permutation; a dot product sums its
//   128-bit products exactly and reduces once; carries are PTX carry flags,
//   not compares; lanes are made canonical once, before the store.
// * Registers: one loop runs the 8 full rounds (the partial rounds on one
//   trip), so the full round's code exists once; the matrix is read inside
//   each round and the column index reread at the end, instead of being
//   held across the rounds.  A thread then needs at most 128 registers with
//   no spills, and two blocks of 256 threads share an SM.
// One thread per state column; element i of column b is at i * B + b, so a
// warp's loads and stores of one lane are one contiguous 256-byte run.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;          // per SM: at most 128 registers a thread
constexpr int R = WIDTH - 1;           // lanes 1 .. 11 of the partial rounds

// The fast partial rounds' tables, packed in this order (u64 words).
constexpr int FAST_FIRST = 0;                          // [12]
constexpr int FAST_INITIAL = FAST_FIRST + WIDTH;       // [11][11]
constexpr int FAST_POST = FAST_INITIAL + R * R;        // [22]
constexpr int FAST_M00 = FAST_POST + PARTIAL;          // [22]
constexpr int FAST_V = FAST_M00 + PARTIAL;             // [22][11]
constexpr int FAST_W = FAST_V + PARTIAL * R;           // [22][11]
constexpr int FAST_WORDS = FAST_W + PARTIAL * R;

__constant__ uint64_t c_rc[ROUNDS * WIDTH];
__constant__ uint64_t c_mds[WIDTH * WIDTH];
__constant__ uint32_t c_mds32[WIDTH * WIDTH];
__constant__ uint64_t c_fast[FAST_WORDS];

using namespace goldilocks;

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
    const uint64_t x2 = mul_lazy(x, x);
    return mul_lazy(mul_lazy(x2, x), mul_lazy(x2, x2));     // x^3 * x^4: depth 3
}

// acc_lo + acc_hi * 2^32 mod p (lazy), both accumulators < 2^56.
__device__ __forceinline__ uint64_t reduce_small(uint64_t acc_lo, uint64_t acc_hi) {
    const uint64_t d = acc_lo + (acc_hi >> 32) * EPSILON;    // < 2^57
    const uint64_t t = d + (acc_hi << 32);                  // may wrap once
    return t < d ? t + EPSILON : t;
}

template <bool SMALL_MDS>
__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
    // An offset of 0 that the compiler cannot see through: the matrix is then
    // read inside each round, not hoisted out of the round loops into
    // registers, which would spill.
    int base = 0;
    asm volatile("" : "+r"(base));
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = sbox(add_lazy(s[i], c_rc[r * WIDTH + i]));
    uint64_t out[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
        if (SMALL_MDS) {
            uint64_t lo = 0, hi = 0;
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) {
                lo += (uint64_t)c_mds32[base + i * WIDTH + j] * (uint32_t)s[j];
                hi += (uint64_t)c_mds32[base + i * WIDTH + j] * (uint32_t)(s[j] >> 32);
            }
            out[i] = reduce_small(lo, hi);
        } else {
            Acc acc;
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) acc.mul_add(c_mds[base + i * WIDTH + j], s[j]);
            out[i] = acc.reduce();
        }
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = out[i];
}

// The 22 partial rounds, in the fast form of `fast_partial_tables`.
__device__ __forceinline__ void partial_rounds(uint64_t s[WIDTH]) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = add_lazy(s[i], c_fast[FAST_FIRST + i]);
    uint64_t t[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        Acc acc;
#pragma unroll
        for (int j = 0; j < R; ++j) acc.mul_add(c_fast[FAST_INITIAL + i * R + j], s[1 + j]);
        t[i] = acc.reduce();
    }
#pragma unroll
    for (int i = 0; i < R; ++i) s[1 + i] = t[i];
#pragma unroll 1
    for (int r = 0; r < PARTIAL; ++r) {
        const uint64_t s0 = add_lazy(sbox(s[0]), c_fast[FAST_POST + r]);
        Acc acc;
        acc.mul_add(c_fast[FAST_M00 + r], s0);
#pragma unroll
        for (int j = 0; j < R; ++j) acc.mul_add(c_fast[FAST_V + r * R + j], s[1 + j]);
#pragma unroll
        for (int j = 0; j < R; ++j) {
            // s[1 + j] + w * s0 < 2^128: one reduction.
            uint64_t hi, lo;
            mul_wide(c_fast[FAST_W + r * R + j], s0, hi, lo);
            asm("add.cc.u64 %0, %0, %2;\n\t"
                "addc.u64 %1, %1, 0;"
                : "+l"(lo), "+l"(hi) : "l"(s[1 + j]));
            s[1 + j] = reduce128_lazy(hi, lo);
        }
        s[0] = acc.reduce();
    }
}

// This thread's column, read from the special registers at each call: a
// value kept from the loads to the stores would hold two registers across
// all 30 rounds, and with 128 of them in use it would spill.
__device__ __forceinline__ int64_t column() {
    uint32_t tid, cta;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
    return (int64_t)cta * THREADS + tid;
}

template <bool SMALL_MDS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
permute_cols_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t batch) {
    int64_t b = column();
    if (b >= batch) return;
    uint64_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = in[i * batch + b];
    // One loop over the 8 full rounds, so the full round's code exists once.
#pragma unroll 1
    for (int r = 0; r < 2 * HALF_FULL; ++r) {
        if (r == HALF_FULL) partial_rounds(s);
        full_round<SMALL_MDS>(s, r < HALF_FULL ? r : r + PARTIAL);
    }
    b = column();
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) out[i * batch + b] = canon(s[i]);
}

// Field-layer check: rows of `out` are add, sub, mul, neg(a) of canonical
// a and b, then, for any u64 a and b and made canonical: mul_lazy(a, b),
// reduce128_lazy(hi = a, lo = b), add_lazy(a, canon(b)), sub_lazy(a,
// canon(b)) and an Acc of twelve products a * b; then K3's lazy butterfly
// (e, o) of dif_lazy(a, b, w) and of dif_lazy(a, b), w = 1.
__global__ void gl_ops_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                              const uint64_t* __restrict__ w, uint64_t* __restrict__ out,
                              int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint64_t x = a[i], y = b[i];
    out[i] = add(x, y);
    out[n + i] = sub(x, y);
    out[2 * n + i] = mul(x, y);
    out[3 * n + i] = neg(x);
    out[4 * n + i] = canon(mul_lazy(x, y));
    out[5 * n + i] = canon(reduce128_lazy(x, y));
    out[6 * n + i] = canon(add_lazy(x, canon(y)));
    out[7 * n + i] = canon(sub_lazy(x, canon(y)));
    Acc acc;
    for (int k = 0; k < 12; ++k) acc.mul_add(x, y);
    out[8 * n + i] = canon(acc.reduce());
    uint64_t e = x, o = y;
    dif_lazy(e, o, w[i]);
    out[9 * n + i] = canon(e);
    out[10 * n + i] = canon(o);
    e = x, o = y;
    dif_lazy(e, o);
    out[11 * n + i] = canon(e);
    out[12 * n + i] = canon(o);
}

}  // namespace

extern "C" {

// Copies into constant memory of the current device, from host arrays of
// canonical u64: the round constants [30 * 12] (the full rounds' rows are
// read), the MDS matrix [12 * 12] (also kept as uint32_t for the
// small-entry layer, whose entries are < 2^20) and the fast partial
// rounds' tables, packed as first [12], initial [11 * 11], post [22], m00
// [22], v [22 * 11], w [22 * 11] (poseidon.fast_partial_tables).
int p2t_poseidon_set_constants(const uint64_t* rc, const uint64_t* mds, const uint64_t* fast) {
    uint32_t mds32[WIDTH * WIDTH];
    for (int i = 0; i < WIDTH * WIDTH; ++i) mds32[i] = (uint32_t)mds[i];
    cudaError_t err = cudaMemcpyToSymbol(c_rc, rc, sizeof(uint64_t) * ROUNDS * WIDTH);
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_mds, mds, sizeof(uint64_t) * WIDTH * WIDTH);
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_mds32, mds32, sizeof(mds32));
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_fast, fast, sizeof(uint64_t) * FAST_WORDS);
    return (int)err;
}

// in, out: distinct device [12, batch] row-major u64.  small_mds != 0
// takes the small-entry MDS layer, which is right only when every entry of
// the uploaded matrix is < 2^20; 0 takes the generic layer.
int p2t_poseidon_permute_cols(const uint64_t* in, uint64_t* out, int64_t batch, int small_mds,
                              void* stream) {
    if (batch <= 0) return 0;
    const unsigned blocks = (unsigned)((batch + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (small_mds)
        permute_cols_kernel<true><<<blocks, THREADS, 0, s>>>(in, out, batch);
    else
        permute_cols_kernel<false><<<blocks, THREADS, 0, s>>>(in, out, batch);
    return (int)cudaGetLastError();
}

// a, b, w: device [n] u64; out: device [13, n] u64.
int p2t_gl_ops(const uint64_t* a, const uint64_t* b, const uint64_t* w, uint64_t* out, int64_t n,
               void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    gl_ops_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a, b, w, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
