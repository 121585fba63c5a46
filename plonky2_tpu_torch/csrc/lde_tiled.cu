// Kernel K3: values over H -> (natural coefficients, coset LDE in
// bit-reversed order) for 2^14 <= n <= 2^20 and rate_bits <= 6, as a
// four-step transform n = n1 * n2.
//
// Replaces plonky2_tpu/ntt/pallas_lde_tiled.py `lde_from_values_tiled_rev`
// (kernels A-D of `_build_tiled`), which streams [n1, 128]-lane column tiles
// and row tiles through VMEM and leaves the coefficient gather to XLA.
//
// Why K2's design stops at 2^13: K2 keeps a whole polynomial in one block's
// shared memory.  A block has at most 227 KB; a polynomial takes 128 KB at
// n = 2^14 and 256 KB at 2^15.  So here a polynomial is an [n1, n2] matrix
// (index i = i1 * n2 + i2) and never lies whole in one block.  With
// rev_n(j1 * n2 + j2) = rev_n1(j1) + n1 * rev_n2(j2), a decimation-in-
// frequency transform of the whole polynomial is
//   column DIF over i1 -> twiddle w_n^(rev_n1(j1) * i2) -> row DIF over i2
// and the bit-reversed output order absorbs the transpose of the textbook
// four-step algorithm.  Four passes, each one read and one write of device
// memory:
//   A  column inverse DIF, times w_n^-(rev_n1(j1) * i2)       values  -> scratch
//   B  row inverse DIF, times 1/n; the coefficient at (j1, j2) has natural
//      index rev_n1(j1) + n1 * rev_n2(j2), so a block takes the rows j1 whose
//      rev_n1(j1) are consecutive and writes natural coefficients directly,
//      R consecutive elements for every j2                  scratch -> coeffs
//   C  per coset: scale coefficient j1 * n2 + j2 by s_k^j = u[kk][j1] * v[kk][j2]
//      (coset kk computes k = rev_r(kk), so that the cosets come out in the
//      big domain's bit-reversed order), column forward DIF, times
//      w_n^(rev_n1(r1) * j2)                                coeffs  -> lde
//   D  row forward DIF, in place                            lde     -> lde
// Coset kk's n values then sit at lde[kk * n + p] in bit-reversed order p,
// which is the big domain's bit-reversed order.
//
// What bounds it on an H100: 64-bit modular multiplies (one per butterfly,
// two per element for the coset scale, one per element for each twiddle
// pass) and the shared-memory round trips between butterfly stages.  Device
// memory sees about 4 reads and 4 writes of n words per polynomial for the
// inverse half and 2 of each per coset for the forward half.
//
// What the design does about it: every tile is 8192 words (64 KB of shared
// memory, so three blocks fit an SM): a column tile is n1 rows by C = 8192 / n1
// adjacent columns (C >= 8 words, 64-byte runs for every row), a row tile is
// R = 8192 / n2 whole rows.  Loads and stores are coalesced: threads walk a
// tile's fastest axis.  Butterflies run in shared memory, the twiddles of
// each length come from one host table read through the read-only cache, and
// the inter-pass twiddle and coset-scale tables are built once on the host
// per (log n, rate, shift).  The forward passes C and D share the LDE buffer:
// no scratch of [b, 2^rate, n].  Nothing is asynchronous yet; TMA, a
// persistent grid and fusing A with B are work for later.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

using namespace goldilocks;

constexpr int THREADS = 256;
constexpr int LOG_TILE = 13;                 // words per tile: 8192
constexpr int MIN_LOG_N = 14;
constexpr int MAX_LOG_N = 20;

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
    return bits == 0 ? 0u : (__brev(x) >> (32 - bits));
}

// DIF over 2^log_count independent transforms of length 2^log_len in shared
// memory: element e of transform t at x[t * tstride + e * estride].  Natural
// in, bit-reversed out.  tw[q] = w_len^q (q < len / 2), forward or inverse
// root; the half-size-m stage uses w_{2m}^q = tw[q * len / (2m)].  COLUMNS:
// consecutive threads take consecutive transforms (a column tile, where
// transforms are adjacent words); otherwise consecutive butterflies of one
// transform (a row tile).
template <bool COLUMNS>
__device__ __forceinline__ void dif_tile(uint64_t* x, const uint64_t* __restrict__ tw,
                                         int log_len, int log_count, int tstride, int estride) {
    const int log_half = log_len - 1;
    const int total = 1 << (log_half + log_count);
    for (int s = log_half; s >= 0; --s) {
        const int m = 1 << s;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            int t, j;
            if (COLUMNS) {
                t = idx & ((1 << log_count) - 1);
                j = idx >> log_count;
            } else {
                j = idx & ((1 << log_half) - 1);
                t = idx >> log_half;
            }
            const int q = j & (m - 1);
            const int i0 = ((j >> s) << (s + 1)) | q;
            uint64_t* p0 = x + t * tstride + i0 * estride;
            uint64_t* p1 = p0 + m * estride;
            const uint64_t e = *p0;
            const uint64_t o = *p1;
            *p0 = add(e, o);
            *p1 = mul(sub(e, o), __ldg(&tw[q << (log_half - s)]));
        }
        __syncthreads();
    }
}

// A: one (polynomial, column group) per block.
__global__ void col_inverse_kernel(const uint64_t* __restrict__ values, uint64_t* __restrict__ scratch,
                                   const uint64_t* __restrict__ tw1_inv,
                                   const uint64_t* __restrict__ t_inv, int log_n1, int log_n2) {
    extern __shared__ uint64_t x[];
    const int log_c = LOG_TILE - log_n1;
    const int groups = 1 << (log_n2 - log_c);
    const int64_t poly = blockIdx.x / groups;
    const int c0 = (blockIdx.x % groups) << log_c;
    const int n2 = 1 << log_n2;
    const int64_t base = poly << (log_n1 + log_n2);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) {
        const int i1 = e >> log_c, c = e & ((1 << log_c) - 1);
        x[e] = values[base + (int64_t)i1 * n2 + c0 + c];
    }
    __syncthreads();
    dif_tile<true>(x, tw1_inv, log_n1, log_c, 1, 1 << log_c);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) {
        const int j1 = e >> log_c, c = e & ((1 << log_c) - 1);
        const int off = j1 * n2 + c0 + c;
        scratch[base + off] = mul(x[e], __ldg(&t_inv[off]));
    }
}

// B: one (polynomial, row group) per block; rows padded by one word in
// shared memory so that the column-wise store reads hit distinct banks.
__global__ void row_inverse_kernel(const uint64_t* __restrict__ scratch, uint64_t* __restrict__ coeffs,
                                   const uint64_t* __restrict__ tw2_inv, int log_n1, int log_n2,
                                   uint64_t n_inv) {
    extern __shared__ uint64_t x[];
    const int log_r = LOG_TILE - log_n2;
    const int groups = 1 << (log_n1 - log_r);
    const int64_t poly = blockIdx.x / groups;
    const int c0 = (blockIdx.x % groups) << log_r;    // natural-index offset of the first row
    const int n1 = 1 << log_n1, n2 = 1 << log_n2;
    const int stride = n2 + 1;
    const int64_t base = poly << (log_n1 + log_n2);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) {
        const int r = e >> log_n2, i2 = e & (n2 - 1);
        const int j1 = (int)bitrev((unsigned)(c0 + r), log_n1);
        x[r * stride + i2] = scratch[base + (int64_t)j1 * n2 + i2];
    }
    __syncthreads();
    dif_tile<false>(x, tw2_inv, log_n2, log_r, stride, 1);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) {
        const int r = e & ((1 << log_r) - 1), j2 = e >> log_r;
        const int64_t nat = (int64_t)(c0 + r) + (int64_t)n1 * bitrev((unsigned)j2, log_n2);
        coeffs[base + nat] = mul(x[r * stride + j2], n_inv);
    }
}

// C: one (polynomial, coset block kk, column group) per block.
__global__ void col_forward_kernel(const uint64_t* __restrict__ coeffs, uint64_t* __restrict__ lde,
                                   const uint64_t* __restrict__ tw1_fwd,
                                   const uint64_t* __restrict__ t_fwd,
                                   const uint64_t* __restrict__ scale_u,
                                   const uint64_t* __restrict__ scale_v, int log_n1, int log_n2,
                                   int rate_bits) {
    extern __shared__ uint64_t x[];
    const int log_c = LOG_TILE - log_n1;
    const int groups = 1 << (log_n2 - log_c);
    const int log_n = log_n1 + log_n2;
    const int64_t pk = blockIdx.x / groups;           // poly * 2^rate + kk
    const int64_t poly = pk >> rate_bits;
    const int kk = (int)(pk & ((1 << rate_bits) - 1));
    const int c0 = (blockIdx.x % groups) << log_c;
    const int n1 = 1 << log_n1, n2 = 1 << log_n2;
    const uint64_t* u = scale_u + (int64_t)kk * n1;
    const uint64_t* v = scale_v + (int64_t)kk * n2;
    const uint64_t* src = coeffs + (poly << log_n);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) {
        const int j1 = e >> log_c, c = e & ((1 << log_c) - 1);
        const uint64_t s = mul(__ldg(&u[j1]), __ldg(&v[c0 + c]));
        x[e] = mul(src[(int64_t)j1 * n2 + c0 + c], s);
    }
    __syncthreads();
    dif_tile<true>(x, tw1_fwd, log_n1, log_c, 1, 1 << log_c);
    uint64_t* dst = lde + (pk << log_n);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) {
        const int r1 = e >> log_c, c = e & ((1 << log_c) - 1);
        const int off = r1 * n2 + c0 + c;
        dst[off] = mul(x[e], __ldg(&t_fwd[off]));
    }
}

// D: one (polynomial, coset block, row group) per block, in place.
__global__ void row_forward_kernel(uint64_t* __restrict__ lde, const uint64_t* __restrict__ tw2_fwd,
                                   int log_n1, int log_n2) {
    extern __shared__ uint64_t x[];
    const int log_r = LOG_TILE - log_n2;
    const int groups = 1 << (log_n1 - log_r);
    const int64_t pk = blockIdx.x / groups;
    const int r0 = (blockIdx.x % groups) << log_r;
    uint64_t* rows = lde + (pk << (log_n1 + log_n2)) + ((int64_t)r0 << log_n2);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) x[e] = rows[e];
    __syncthreads();
    dif_tile<false>(x, tw2_fwd, log_n2, log_r, 1 << log_n2, 1);
    for (int e = threadIdx.x; e < (1 << LOG_TILE); e += blockDim.x) rows[e] = x[e];
}

}  // namespace

extern "C" {

// values, coeffs, scratch: device [batch, n]; lde: device [batch, n << rate_bits].
// tw1_inv/tw1_fwd: [n1 / 2] powers of w_n1^(-1) / w_n1; tw2_inv/tw2_fwd:
// [n2 / 2] powers of w_n2^(-1) / w_n2; t_inv/t_fwd: [n1, n2] with
// t[j1][i2] = w_n^(-+rev_n1(j1) * i2); scale_u: [2^rate, n1], scale_v:
// [2^rate, n2] with u[kk][j1] * v[kk][j2] = s_k^(j1 * n2 + j2),
// s_k = shift * w_N^rev_rate(kk).  All u64 canonical.
// Requires 14 <= log_n <= 20, log_n1 + log_n2 = log_n with
// 7 <= log_n1, log_n2 <= 13, and rate_bits <= 6.
int p2t_lde_tiled_rev(const uint64_t* values, uint64_t* coeffs, uint64_t* lde, uint64_t* scratch,
                      const uint64_t* tw1_inv, const uint64_t* tw1_fwd, const uint64_t* tw2_inv,
                      const uint64_t* tw2_fwd, const uint64_t* t_inv, const uint64_t* t_fwd,
                      const uint64_t* scale_u, const uint64_t* scale_v, int64_t batch, int log_n1,
                      int log_n2, int rate_bits, uint64_t n_inv, void* stream) {
    const int log_n = log_n1 + log_n2;
    if (log_n < MIN_LOG_N || log_n > MAX_LOG_N || log_n1 < LOG_TILE - 6 || log_n2 < LOG_TILE - 6 ||
        log_n1 > LOG_TILE || log_n2 > LOG_TILE || rate_bits < 0 || rate_bits > 6)
        return (int)cudaErrorInvalidValue;
    if (batch <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const int tile = (int)sizeof(uint64_t) << LOG_TILE;
    const int tile_padded = tile + (int)sizeof(uint64_t) * (1 << (LOG_TILE - log_n2));
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(col_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    tile)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(row_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    tile_padded)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(col_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    tile)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(row_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    tile)) != cudaSuccess)
        return (int)err;
    const int64_t col_blocks = batch << (log_n - LOG_TILE);     // tiles per polynomial: n / 8192
    const int64_t fwd_blocks = col_blocks << rate_bits;
    col_inverse_kernel<<<(unsigned)col_blocks, THREADS, tile, s>>>(values, scratch, tw1_inv, t_inv,
                                                                   log_n1, log_n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    row_inverse_kernel<<<(unsigned)col_blocks, THREADS, tile_padded, s>>>(scratch, coeffs, tw2_inv,
                                                                          log_n1, log_n2, n_inv);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    col_forward_kernel<<<(unsigned)fwd_blocks, THREADS, tile, s>>>(coeffs, lde, tw1_fwd, t_fwd,
                                                                   scale_u, scale_v, log_n1, log_n2,
                                                                   rate_bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    row_forward_kernel<<<(unsigned)fwd_blocks, THREADS, tile, s>>>(lde, tw2_fwd, log_n1, log_n2);
    return (int)cudaGetLastError();
}

}  // extern "C"
