// Kernel K2: values over H -> (coefficients, coset LDE), for one batch of
// polynomials of size n <= 2^13, with the LDE in bit-reversed order (K2-rev,
// the commit path) or in natural order (K2-nat).
//
// Replaces plonky2_tpu/ntt/pallas_lde.py `lde_from_values_pallas_rev` and
// `lde_from_values_pallas` (one kernel body, `_build`), which keep one
// polynomial in VMEM as u32 planes for the whole inverse-NTT -> scale ->
// 2^rate forward NTTs chain and leave the coefficient gather and the
// reorder (bit-reversed) or interleave (natural) of the LDE to XLA.
//
// What bounded the first design on the H100 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): at [135, 2^12] rate 3 it took 0.2720 ms against a 0.0133 ms
// memory bound, bound by 32-bit integer instructions.  Its grid was
// (polynomial, coset), so each of a polynomial's 2^rate blocks reran the
// inverse transform (8 inverse NTTs a polynomial at rate 3 where one is
// needed), and every butterfly ran alone in shared memory: index
// arithmetic, two loads, two stores and the canonical 35-instruction
// mulmod, ~80 SASS instructions, and one __syncthreads a stage.
//
// Two kernel bodies, chosen by size (a size dispatch, not a fallback):
// - 2^11 <= n <= 2^13: two launches a call.
//   1. k2_inverse_kernel, one block a polynomial, runs the inverse DIF
//      (natural in, bit-reversed out) in register groups of 8 to 32
//      elements a thread: K3's `radix`/`run_group` (ntt_groups.cuh) with
//      the lazy butterfly goldilocks::dif_lazy, split 11 = 3+4+4,
//      12 = 4+4+4, 13 = 3+3+3+4 (top index bits first), shared memory
//      only between groups.  The last group multiplies by 1/n, makes each value
//      canonical and puts it at its natural index in a second shared
//      buffer, from which the coefficients leave as coalesced stores.
//   2. k2_forward_kernel, one block a (polynomial, coset k), reads the
//      coefficients back (L2-resident: 4.4 MB at [135, 2^12]), multiplies
//      coefficient j by (shift * w_N^k)^j in the first group's loads, runs
//      the forward DIF in the same register groups and makes the values
//      canonical at the store: position r holds L[k + 2^rate * rev_n(r)].
//      K2-rev writes it as it is, at rev_rate(k) * n + r, one contiguous
//      n-word run a block, through shared memory so that it leaves
//      coalesced.  K2-nat puts value r at natural index rev_n(r) of a
//      second shared buffer and writes L[k + 2^rate * i] to position k +
//      2^rate * i: a polynomial's 2^rate blocks interleave their stores.
//   Shared words are padded so that no half-warp's accesses meet on a
//   bank: one pad word every 16 in the transform buffer (the last group
//   holds 16 elements 16 words apart in a thread), one every
//   2^(log n - 8) in the natural-order buffer (the last group's natural
//   indices lie 2^(log n - 8) apart across a half-warp).
// - n <= 2^10: lde_kernel, the first design: one block a (polynomial,
//   coset) repeats the inverse transform, one butterfly at a time in
//   shared memory.  At these sizes (the golden tiny circuit has n = 4) a
//   call is a few microseconds of work, and one launch instead of two.
// Twiddle and coset tables are built once on the host per (log n, rate,
// shift) and read through the read-only cache.
//
// What bounds it now (same card, bench/kernel_time.py, bench/sass.py;
// PERF.md): at [135, 2^12] rate 3 it takes 0.101 ms, of which the forward
// launch 0.074 and the inverse 0.021; a butterfly is 50-54 SASS
// instructions with the load's scale or 1/n mulmod counted in.  The
// forward launch, 1080 blocks, issues instructions as fast as K3's passes:
// integer instructions bound it.  The inverse launch, one block of 8 warps
// an SM, issues at under half that rate: its dependent chains and barriers
// are not hidden by other warps.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"
#include "ntt_groups.cuh"

namespace {

using namespace goldilocks;

constexpr int MAX_THREADS = 512;
constexpr int MAX_LOG_N = 13;
constexpr int MIN_LOG_N_GROUPS = 11;       // the register-group kernels from here up
constexpr int LOG_PAD = 4;                 // the transform buffer: a pad word every 2^LOG_PAD

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
    return bits == 0 ? 0u : (__brev(x) >> (32 - bits));
}

// ---------------------------------------------------------------------
// n <= 2^10: one block a (polynomial, coset), a butterfly at a time.
// ---------------------------------------------------------------------

// In-place DIF NTT over shared memory x[0..n): natural in, bit-reversed out.
// tw[t] = w_n^t (t < n/2) for the forward transform, w_n^-t for the inverse;
// the half-size-m stage uses w_{2m}^t = tw[t * n / (2m)].
__device__ __forceinline__ void dif(uint64_t* x, const uint64_t* __restrict__ tw, int log_n) {
    const int half = 1 << (log_n - 1);
    for (int s = log_n - 1; s >= 0; --s) {
        const int m = 1 << s;
        for (int j = threadIdx.x; j < half; j += blockDim.x) {
            const int t = j & (m - 1);
            const int i0 = ((j >> s) << (s + 1)) | t;
            const int i1 = i0 + m;
            const uint64_t e = x[i0];
            const uint64_t o = x[i1];
            x[i0] = add(e, o);
            x[i1] = mul(sub(e, o), __ldg(&tw[t << (log_n - 1 - s)]));
        }
        __syncthreads();
    }
}

// Swap x[0..n) from bit-reversed into natural order.
__device__ __forceinline__ void bitrev_swap(uint64_t* x, int log_n) {
    for (int j = threadIdx.x; j < (1 << log_n); j += blockDim.x) {
        const int r = (int)bitrev((unsigned)j, log_n);
        if (j < r) {
            const uint64_t t = x[j];
            x[j] = x[r];
            x[r] = t;
        }
    }
    __syncthreads();
}

template <bool NATURAL>
__global__ void lde_kernel(const uint64_t* __restrict__ values, uint64_t* __restrict__ coeffs,
                           uint64_t* __restrict__ lde, const uint64_t* __restrict__ tw_inv,
                           const uint64_t* __restrict__ tw_fwd,
                           const uint64_t* __restrict__ coset_pows, int log_n, int rate_bits,
                           uint64_t n_inv) {
    extern __shared__ uint64_t x[];
    const int n = 1 << log_n;
    const int64_t poly = blockIdx.x;
    const int k = blockIdx.y;

    const uint64_t* v = values + poly * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = v[i];
    __syncthreads();

    dif(x, tw_inv, log_n);                       // x[r] = n * coeff[rev(r)]
    bitrev_swap(x, log_n);

    const uint64_t* pk = coset_pows + (int64_t)k * n;
    uint64_t* c = coeffs + poly * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const uint64_t cj = mul(x[j], n_inv);
        if (k == 0) c[j] = cj;
        x[j] = mul(cj, __ldg(&pk[j]));
    }
    __syncthreads();

    dif(x, tw_fwd, log_n);                       // x[r] = L[k + 2^rate * rev(r)]

    uint64_t* dst = lde + poly * ((int64_t)n << rate_bits);
    if (NATURAL) {
        bitrev_swap(x, log_n);
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            dst[k + ((int64_t)i << rate_bits)] = x[i];
    } else {
        dst += (int64_t)bitrev((unsigned)k, rate_bits) * n;
        for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = x[j];
    }
}

template <bool NATURAL>
cudaError_t launch_small(const uint64_t* values, uint64_t* coeffs, uint64_t* lde,
                         const uint64_t* tw_inv, const uint64_t* tw_fwd,
                         const uint64_t* coset_pows, int64_t batch, int log_n, int rate_bits,
                         uint64_t n_inv, cudaStream_t stream) {
    const int n = 1 << log_n;
    const size_t smem = sizeof(uint64_t) * (size_t)n;
    cudaError_t err = cudaFuncSetAttribute(lde_kernel<NATURAL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int threads = n / 2 < MAX_THREADS ? n / 2 : MAX_THREADS;
    const dim3 grid((unsigned)batch, 1u << rate_bits);
    lde_kernel<NATURAL><<<grid, threads, smem, stream>>>(values, coeffs, lde, tw_inv, tw_fwd,
                                                        coset_pows, log_n, rate_bits, n_inv);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------
// 2^11 <= n <= 2^13: an inverse launch and a forward launch, register groups.
// ---------------------------------------------------------------------

// The split of log n into register groups, top index bits first: 11 =
// 3+4+4, 12 = 4+4+4, 13 = 3+3+3+4 (5+4+4 spills at 128 registers).  The
// last group's 16 elements of a thread lie 16 words apart (LOG_PAD); the
// others start at index bit 4 or above.
__host__ __device__ constexpr int num_groups(int log_n) { return log_n == 13 ? 4 : 3; }

__host__ __device__ constexpr int group_k(int log_n, int g) {
    return log_n == 13 ? (g == 3 ? LOG_PAD : 3) : (g == 0 ? log_n - 8 : LOG_PAD);
}

// The index bits below group g.
__host__ __device__ constexpr int group_lo(int log_n, int g) {
    return g < 0 ? log_n : group_lo(log_n, g - 1) - group_k(log_n, g);
}

// Threads a block: one register group of 16 a thread, at most 256 (K3's
// block); at 2^13 a group of 8 is a loop of 4 trips and one of 16 of 2.
__host__ __device__ constexpr int threads_for(int log_n) {
    return log_n - LOG_PAD < 8 ? 1 << (log_n - LOG_PAD) : 256;
}

// Blocks an SM that the kernels keep registers for (__launch_bounds__).
// Forward: 24 warps, as K3's passes.  Inverse: 16 warps, so that where a
// batch has more polynomials than the card has SMs, two blocks share an SM
// instead of queueing.
__host__ __device__ constexpr int forward_blocks(int log_n) { return 768 / threads_for(log_n); }

__host__ __device__ constexpr int inverse_blocks(int log_n) { return 512 / threads_for(log_n); }

// Shared words: the transform buffer, and the natural-order buffer.
__host__ __device__ constexpr int transform_words(int log_n) {
    return (1 << log_n) + (1 << (log_n - LOG_PAD));
}

__host__ __device__ constexpr int natural_words(int log_n) { return (1 << log_n) + (1 << 8); }

__device__ __forceinline__ int tslot(int i) { return i + (i >> LOG_PAD); }

template <int L>
__device__ __forceinline__ int nslot(int i) {
    return i + (i >> (L - 8));
}

// Register groups G, G + 1, ... of the block's transform of 2^L points,
// x holding it between groups: the last group hands element r of the
// bit-reversed output to last(_, r, value).
template <int L, int G, class Last>
__device__ __forceinline__ void groups_from(uint64_t* x, const uint64_t* __restrict__ tw,
                                            Last last) {
    constexpr int T = threads_for(L);
    auto sload = [&](int, int i) { return x[tslot(i)]; };
    if constexpr (G == num_groups(L) - 1) {
        static_assert(group_lo(L, G) == 0, "the groups must cover the transform");
        ntt_groups::run_group<L, L, group_k(L, G), 0, T, false>(tw, sload, last);
    } else {
        ntt_groups::run_group<L, L, group_k(L, G), group_lo(L, G), T, false>(
            tw, sload, [&](int, int i, uint64_t v) { x[tslot(i)] = v; });
        __syncthreads();
        groups_from<L, G + 1>(x, tw, last);
    }
}

// The whole DIF of the block's transform: the first group reads load(_, i)
// (natural order), the last hands over the bit-reversed output; a barrier
// after it.
template <int L, class Load, class Last>
__device__ __forceinline__ void transform(uint64_t* x, const uint64_t* __restrict__ tw, Load load,
                                          Last last) {
    ntt_groups::run_group<L, L, group_k(L, 0), group_lo(L, 0), threads_for(L), false>(
        tw, load, [&](int, int i, uint64_t v) { x[tslot(i)] = v; });
    __syncthreads();
    groups_from<L, 1>(x, tw, last);
    __syncthreads();
}

// f(i) for every word i < 2^L of the block, consecutive threads on
// consecutive words.
template <int L, class F>
__device__ __forceinline__ void for_each_word(F f) {
    constexpr int T = threads_for(L);
#pragma unroll
    for (int q = 0; q < (1 << L) / T; ++q) f(threadIdx.x + q * T);
}

// One block a polynomial: values -> coeffs (natural order, canonical).
template <int L>
__global__ void __launch_bounds__(threads_for(L), inverse_blocks(L))
k2_inverse_kernel(const uint64_t* __restrict__ values, uint64_t* __restrict__ coeffs,
                  const uint64_t* __restrict__ tw_inv, uint64_t n_inv) {
    extern __shared__ uint64_t sm[];
    uint64_t* x = sm;
    uint64_t* nat = sm + transform_words(L);
    const int64_t off = (int64_t)blockIdx.x << L;
    const uint64_t* v = values + off;
    transform<L>(x, tw_inv, [&](int, int i) { return v[i]; }, [&](int, int r, uint64_t y) {
        nat[nslot<L>((int)bitrev((unsigned)r, L))] = canon(mul_lazy(y, n_inv));
    });
    uint64_t* c = coeffs + off;
    for_each_word<L>([&](int i) { c[i] = nat[nslot<L>(i)]; });
}

// One block a (polynomial, coset k), k the low rate_bits bits of the block
// index: coeffs -> the coset's n values of the LDE.
template <int L, bool NATURAL>
__global__ void __launch_bounds__(threads_for(L), forward_blocks(L))
k2_forward_kernel(const uint64_t* __restrict__ coeffs, uint64_t* __restrict__ lde,
                  const uint64_t* __restrict__ tw_fwd, const uint64_t* __restrict__ coset_pows,
                  int rate_bits) {
    extern __shared__ uint64_t sm[];
    uint64_t* x = sm;
    const int64_t poly = blockIdx.x >> rate_bits;
    const int k = blockIdx.x & ((1 << rate_bits) - 1);
    const uint64_t* c = coeffs + (poly << L);
    const uint64_t* pk = coset_pows + ((int64_t)k << L);
    uint64_t* dst = lde + ((poly << rate_bits) << L);
    auto load = [&](int, int i) { return mul_lazy(c[i], __ldg(&pk[i])); };
    if constexpr (NATURAL) {
        uint64_t* nat = sm + transform_words(L);
        transform<L>(x, tw_fwd, load, [&](int, int r, uint64_t y) {
            nat[nslot<L>((int)bitrev((unsigned)r, L))] = canon(y);
        });
        for_each_word<L>([&](int i) { dst[k + ((int64_t)i << rate_bits)] = nat[nslot<L>(i)]; });
    } else {
        transform<L>(x, tw_fwd, load, [&](int, int r, uint64_t y) { x[tslot(r)] = canon(y); });
        dst += (int64_t)bitrev((unsigned)k, rate_bits) << L;
        for_each_word<L>([&](int r) { dst[r] = x[tslot(r)]; });
    }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int L>
cudaError_t launch_groups(const uint64_t* values, uint64_t* coeffs, uint64_t* lde,
                          const uint64_t* tw_inv, const uint64_t* tw_fwd,
                          const uint64_t* coset_pows, int64_t batch, int rate_bits,
                          uint64_t n_inv, bool natural, cudaStream_t stream) {
    constexpr int T = threads_for(L);
    constexpr int both = (int)sizeof(uint64_t) * (transform_words(L) + natural_words(L));
    constexpr int one = (int)sizeof(uint64_t) * transform_words(L);
    cudaError_t err = allow_smem(k2_inverse_kernel<L>, both);
    if (err != cudaSuccess) return err;
    k2_inverse_kernel<L><<<(unsigned)batch, T, both, stream>>>(values, coeffs, tw_inv, n_inv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto forward = [&](auto kernel, int bytes) {
        cudaError_t e = allow_smem(kernel, bytes);
        if (e != cudaSuccess) return e;
        kernel<<<(unsigned)(batch << rate_bits), T, bytes, stream>>>(coeffs, lde, tw_fwd,
                                                                    coset_pows, rate_bits);
        return cudaGetLastError();
    };
    return natural ? forward(k2_forward_kernel<L, true>, both)
                   : forward(k2_forward_kernel<L, false>, one);
}

}  // namespace

extern "C" {

// values, coeffs: device [batch, n]; lde: device [batch, n << rate_bits];
// tw_inv, tw_fwd: device [n / 2]; coset_pows: device [1 << rate_bits, n].
// All u64 canonical.  Requires 1 <= log_n <= 13 and rate_bits <= 6.
// natural = 0: LDE in bit-reversed order (K2-rev); 1: natural order (K2-nat).
int p2t_lde_from_values(const uint64_t* values, uint64_t* coeffs, uint64_t* lde,
                        const uint64_t* tw_inv, const uint64_t* tw_fwd,
                        const uint64_t* coset_pows, int64_t batch, int log_n, int rate_bits,
                        uint64_t n_inv, int natural, void* stream) {
    if (log_n < 1 || log_n > MAX_LOG_N || rate_bits < 0 || rate_bits > 6)
        return (int)cudaErrorInvalidValue;
    if (batch <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (log_n) {
        case 11: return (int)launch_groups<11>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                               batch, rate_bits, n_inv, natural, s);
        case 12: return (int)launch_groups<12>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                               batch, rate_bits, n_inv, natural, s);
        case 13: return (int)launch_groups<13>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                               batch, rate_bits, n_inv, natural, s);
    }
    return (int)(natural ? launch_small<true>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                              batch, log_n, rate_bits, n_inv, s)
                         : launch_small<false>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                               batch, log_n, rate_bits, n_inv, s));
}

// K2's geometry for n = 2^log_n, MIN_LOG_N_GROUPS <= log_n <= MAX_LOG_N,
// for tools that count its SASS per butterfly: out[0] = threads a block,
// out[1 + g] = the stages of register group g, top bits first, 0 past
// its last (out[1..4]).
int p2t_lde_geometry(int log_n, int* out) {
    if (log_n < MIN_LOG_N_GROUPS || log_n > MAX_LOG_N) return (int)cudaErrorInvalidValue;
    out[0] = threads_for(log_n);
    for (int g = 0; g < 4; ++g) out[1 + g] = g < num_groups(log_n) ? group_k(log_n, g) : 0;
    return 0;
}

}  // extern "C"
