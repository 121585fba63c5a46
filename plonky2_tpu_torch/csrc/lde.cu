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
// What bounds it on an H100: 64-bit modular multiplies (one per butterfly)
// and the shared-memory round trips between butterfly stages; device memory
// sees one read of the values and one write of each output.
//
// What the design does about it: the grid is (polynomial, coset).  Each
// block loads its polynomial into shared memory (n * 8 bytes: 32 KB at
// n = 2^12), runs the inverse NTT as decimation-in-frequency (natural in,
// bit-reversed out), swaps it into natural order and scales by 1/n, which
// gives the coefficients (the coset-0 block writes them, coalesced).  It
// then multiplies coefficient j by (shift * w_N^k)^j for its coset k and
// runs the forward n-point NTT, again as decimation-in-frequency, so the
// result comes out bit-reversed: position r holds L[k + 2^rate * rev_n(r)].
// K2-rev writes it as it is, at rev_reps(k) * n + r, its place in the
// bit-reversed big domain: one contiguous n-element run per block, and no
// reorder pass.  K2-nat swaps it into natural order in shared memory and
// writes L[k + 2^rate * i] to position k + 2^rate * i: the 2^rate blocks of
// a polynomial interleave their stores, each a run of words 2^rate apart.
// Each block repeats the (cheap) inverse transform instead of sharing it,
// which buys 2^rate times more blocks to fill the card's 132 SMs.  Twiddle
// and coset tables are built once on the host per (log n, rate, shift) and
// read through the read-only cache.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

using namespace goldilocks;

constexpr int MAX_THREADS = 512;
constexpr int MAX_LOG_N = 13;

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
    return bits == 0 ? 0u : (__brev(x) >> (32 - bits));
}

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
cudaError_t launch_lde(const uint64_t* values, uint64_t* coeffs, uint64_t* lde,
                       const uint64_t* tw_inv, const uint64_t* tw_fwd, const uint64_t* coset_pows,
                       int64_t batch, int log_n, int rate_bits, uint64_t n_inv,
                       cudaStream_t stream) {
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
    return (int)(natural ? launch_lde<true>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                            batch, log_n, rate_bits, n_inv, s)
                         : launch_lde<false>(values, coeffs, lde, tw_inv, tw_fwd, coset_pows,
                                             batch, log_n, rate_bits, n_inv, s));
}

}  // extern "C"
