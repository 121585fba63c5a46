// Goldilocks field arithmetic, p = 2^64 - 2^32 + 1, as CUDA device functions.
//
// Hopper counterpart of plonky2_tpu/field/gl32.py, the device-function layer
// the TPU kernels share.  Mosaic has no u64, so the TPU layer builds every
// operation from (hi, lo) u32 planes; CUDA has native 64-bit integers, so
// here an element is one canonical uint64_t in [0, p) and the 128-bit product
// comes from `a * b` and `__umul64hi(a, b)`.  The reduction is the one of
// plonky2_tpu/field/gl.py `_reduce128`: 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// The functions down to `sqr` take and return canonical values; the lazy
// forms below them take and return any u64 congruent to the value.

#pragma once

#include <cstdint>

namespace goldilocks {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;   // 2^64 mod p
constexpr uint64_t MASK32 = 0xFFFFFFFFull;

__host__ __device__ __forceinline__ uint64_t canon(uint64_t s) {
    return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    s += (s < a) ? EPSILON : 0;   // carry out of 2^64: add 2^64 mod p, cannot re-wrap
    return canon(s);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    return (a < b) ? d - EPSILON : d;   // borrow: d + p, wrapping
}

__device__ __forceinline__ uint64_t neg(uint64_t a) {
    return a == 0 ? 0 : P - a;
}

// hi * 2^64 + lo mod p:  lo - hi_hi + hi_lo * (2^32 - 1).
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
    const uint64_t hi_hi = hi >> 32;
    const uint64_t hi_lo = hi & MASK32;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPSILON;              // borrow: + p
    const uint64_t t1 = hi_lo * EPSILON;        // < 2^64
    uint64_t s = t0 + t1;
    if (s < t1) s += EPSILON;                   // carry: + 2^64 mod p
    return canon(s);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return reduce128(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t sqr(uint64_t a) {
    return mul(a, a);
}

// ---------------------------------------------------------------------
// Lazy forms: inputs and results are any u64 congruent to the value (not
// necessarily canonical), so a chain of them canonicalises once at its end.
// ---------------------------------------------------------------------

// hi:lo = a * b.  Since a * b <= (2^64 - 1)^2, hi <= 2^64 - 2.  On sm_90a
// `a * b` and `__umul64hi` compile to 13 instructions, four 32 x 32 -> 64
// IMAD.WIDE.U32 with the carries in 64-bit adds to 15 (bench/sass.py).
__device__ __forceinline__ void mul_wide(uint64_t a, uint64_t b, uint64_t& hi, uint64_t& lo) {
    lo = a * b;
    hi = __umul64hi(a, b);
}

// hi * 2^64 + lo mod p, as reduce128 without the final canon: < 2^64.
// t0 = lo - hi_hi, minus EPSILON on a borrow (then t0 = lo - hi_hi + p > 0);
// s = t0 + hi_lo * 2^32 - hi_lo, plus EPSILON on a carry out of 2^64 (the
// sum is then below 2^64 - 2^32, so it cannot wrap again).  The carries
// are PTX carry flags, which take fewer instructions than the compares and
// selects of the same steps in C (bench/sass.py counts both).  The carry of
// the add of hi_lo * 2^32 less the borrow of the subtract of hi_lo is 0 or
// 1: the subtract borrows only after the add carried.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t hi, uint64_t lo) {
    uint32_t l0 = (uint32_t)lo, l1 = (uint32_t)(lo >> 32), m = 0;
    asm("sub.cc.u32 %0, %0, %3;\n\t"       // lo - hi_hi
        "subc.cc.u32 %1, %1, 0;\n\t"
        "subc.u32 %2, 0, 0;\n\t"           // m = borrow ? EPSILON : 0
        "sub.cc.u32 %0, %0, %2;\n\t"
        "subc.u32 %1, %1, 0;\n\t"
        "add.cc.u32 %1, %1, %4;\n\t"       // + hi_lo * 2^32
        "addc.u32 %2, 0, 0;\n\t"
        "sub.cc.u32 %0, %0, %4;\n\t"       // - hi_lo
        "subc.cc.u32 %1, %1, 0;\n\t"
        "subc.u32 %2, %2, 0;\n\t"          // m = carry - borrow, 0 or 1
        "neg.s32 %2, %2;\n\t"              // m = carry out of 2^64 ? EPSILON : 0
        "add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, 0;"
        : "+r"(l0), "+r"(l1), "+r"(m) : "r"((uint32_t)(hi >> 32)), "r"((uint32_t)hi));
    return ((uint64_t)l1 << 32) | l0;
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
    uint64_t hi, lo;
    mul_wide(a, b, hi, lo);
    return reduce128_lazy(hi, lo);
}

// a + b for any a and a canonical b: a + b < 2^64 + p, so after the
// carry's + 2^64 mod p the sum is below p + 2^32 - 1 and cannot wrap again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;
    return s < b ? s + EPSILON : s;
}

// a - b for any a and a canonical b.
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d - EPSILON : d;
}

// Decimation-in-frequency butterfly on lazy values, (e, o, w) -> (e + o,
// (e - o) * w): e, o and w are any u64, and so are the results.  o is made
// canonical once (o < 2^64 < 2p, so one subtraction of p does it), which is
// what add_lazy and sub_lazy ask of their second operand; each of them
// then returns a u64 (see above), and mul_lazy takes and returns any u64.
// So a chain of butterflies never wraps twice, whatever its length, and a
// value is made canonical once, at the store.
__device__ __forceinline__ void dif_lazy(uint64_t& e, uint64_t& o, uint64_t w) {
    const uint64_t oc = canon(o);
    const uint64_t d = sub_lazy(e, oc);
    e = add_lazy(e, oc);
    o = mul_lazy(d, w);
}

// The same butterfly for w = 1.
__device__ __forceinline__ void dif_lazy(uint64_t& e, uint64_t& o) {
    const uint64_t oc = canon(o);
    const uint64_t d = sub_lazy(e, oc);
    e = add_lazy(e, oc);
    o = d;
}

// A sum of up to 2^32 products of two lazy values, kept exactly as
// top * 2^128 + hi * 2^64 + lo and reduced once.
struct Acc {
    uint64_t lo = 0, hi = 0;
    uint32_t top = 0;

    __device__ __forceinline__ void add(uint64_t p_hi, uint64_t p_lo) {
        asm("add.cc.u64 %0, %0, %3;\n\t"
            "addc.cc.u64 %1, %1, %4;\n\t"
            "addc.u32 %2, %2, 0;"
            : "+l"(lo), "+l"(hi), "+r"(top) : "l"(p_lo), "l"(p_hi));
    }

    __device__ __forceinline__ void mul_add(uint64_t a, uint64_t b) {
        uint64_t p_hi, p_lo;
        mul_wide(a, b, p_hi, p_lo);
        add(p_hi, p_lo);
    }

    // 2^128 = 2^96 * 2^32 = -2^32 (mod p); top < 2^32 so top << 32 < p.
    __device__ __forceinline__ uint64_t reduce() const {
        return sub_lazy(reduce128_lazy(hi, lo), (uint64_t)top << 32);
    }
};

}  // namespace goldilocks
