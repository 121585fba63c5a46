// Kernel K3: values over H -> (natural coefficients, coset LDE in
// bit-reversed order) for 2^14 <= n <= 2^20 and rate_bits <= 6, as a
// four-step transform n = n1 * n2.
//
// Replaces plonky2_tpu/ntt/pallas_lde_tiled.py `lde_from_values_tiled_rev`
// (kernels A-D of `_build_tiled`), which streams [n1, 128]-lane column tiles
// and row tiles through VMEM and leaves the coefficient gather to XLA.
//
// The four-step identity.  A polynomial is an [n1, n2] matrix (index
// i = i1 * n2 + i2); with rev_n(j1 * n2 + j2) = rev_n1(j1) + n1 * rev_n2(j2)
// a decimation-in-frequency transform of the whole polynomial is
//   column DIF over i1 -> twiddle w_n^(rev_n1(j1) * i2) -> row DIF over i2
// and the bit-reversed output order absorbs the textbook transpose.  The
// LDE's coset block kk holds coset k = rev_r(kk), s_k = shift * w_N^k, so
// that the blocks stack in the big domain's bit-reversed order; its scale
// s_k^(j1 * n2 + j2) = u[kk][j1] * v[kk][j2] has a factor v that is constant
// down a column, so it commutes with the column DIF and joins the twiddle
// after it.  Four passes, each one read and one write of device memory:
//   A  column inverse DIF, times w_n^-(rev_n1(j1) * i2) / n   values -> scratch
//   B  row inverse DIF; the coefficient at (j1, j2) has natural index
//      rev_n1(j1) + n1 * rev_n2(j2), so a block takes the rows j1 whose
//      rev_n1(j1) are consecutive and writes natural coefficients directly
//                                                           scratch -> coeffs
//   C  one load of a coefficient tile, then for every coset kk: times
//      u[kk][j1], column forward DIF, times
//      v[kk][j2] * w_n^(rev_n1(r1) * j2)                    coeffs  -> lde
//   D  row forward DIF, in place                            lde     -> lde
// The host tables (ntt/cuda_lde_tiled.py): the column and row twiddles, A's
// inter-pass twiddle with 1/n folded in [n1, n2], C's coset twiddle [2^r,
// n1, n2] and the scale u [2^r, n1].  The coset twiddle trades a mulmod an
// element and coset for 2^r * n words on the card, 1/batch of the LDE.
//
// What bounded the first design on the H100 (NVIDIA H100 80GB HBM3, 700 W;
// bench/kernel_time.py, bench/sass.py): at [135, 2^14] rate 3 it took
// 0.788 ms against a 0.0529 ms memory bound, of which pass C 0.364 ms, D
// 0.274, A 0.072 and B 0.056.  Every butterfly ran alone in shared memory:
// index arithmetic, two loads and two stores, a canonical add, sub and mul
// (a mul alone is 35 SASS instructions), 72-89 instructions a butterfly,
// and one __syncthreads per stage.  Pass C reloaded each coefficient tile
// once per coset and spent two mulmods on the scale of each element.
//
// What this design does about it:
// - Register groups.  Each thread holds 2^k elements of one transform
//   (k = 3 or 4) and runs k stages on them in registers with lazy
//   arithmetic (goldilocks::dif_lazy: values stay any u64, canonical once
//   at each pass's store).  A transform of 2^7..2^10 points takes two or
//   three such groups (`group_k`; the group code, ntt_groups.cuh, is
//   shared with K2); shared memory is used only between groups, so a
//   tile has 1 (n1 or n2 <= 2^8) or 2 __syncthreads between its groups
//   instead of one per stage.  A group reads its 2^k - 1
//   twiddles once, and a group's first and last loads go straight to and
//   from device memory where the layout allows (all but D's last store,
//   which goes through shared memory so that rows leave coalesced).
// - Pass C loads a coefficient tile once into shared memory and walks its
//   cosets from it: one mulmod per element and coset for the scale u, one
//   for the combined twiddle.  A block takes all 2^rate cosets of its tile
//   unless that leaves fewer than C_WAVES waves of blocks on the card; then
//   the cosets are split over 2, 4, ... adjacent blocks, each loading the
//   tile once (at [135, 2^14] rate 3, 4 blocks of 2 cosets a tile).
// - Tiles are 8192 words (64 KB of shared memory; C: a 4096-word
//   coefficient tile and a 4096-word work tile), 256 threads a block, at
//   most 80 registers a thread (__launch_bounds__(256, 3)): three blocks,
//   24 warps, an SM, by shared memory and by registers alike.
// - Column tiles put C = tile / n1 adjacent columns in a row of the tile,
//   consecutive threads on consecutive columns; row tiles pad each row by
//   one word so that the last group's row-major reads hit distinct banks.
//   With C < 16 (n1 >= 2^9 in pass C, 2^10 in A) the last group's shared
//   reads have 2- or 4-way bank conflicts; the main paths' n1 is 2^7-2^8.
// What bounds it now: 32-bit integer instructions.  A butterfly is ~47 SASS
// instructions, nearly all integer adds, compares, selects and multiplies,
// which compute capability 9.0 runs at 64 a clock per SM, half the rate at
// which an SM dispatches instructions.  At [135, 2^14] rate 3 pass D's SASS
// instructions would take 0.173 ms at that rate if all of them were such;
// it takes 0.165 ms.  Asynchronous copies of the next tile, more or fewer
// threads, a 4-multiply product and adds on the multiply pipe were each
// measured and made nothing faster (PERF.md).  Fewer integer instructions
// per butterfly are the lever left.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "goldilocks.cuh"
#include "ntt_groups.cuh"

namespace {

using namespace goldilocks;

constexpr int THREADS = 256;
constexpr int LOG_TILE = 13;                 // words per tile of A, B and D: 8192
constexpr int LOG_TILE_C = 12;               // C: a coefficient and a work tile of 4096
constexpr int MIN_LOG_N = 14;
constexpr int MAX_LOG_N = 20;
constexpr int BLOCKS_PER_SM = 3;             // __launch_bounds__ and 64 KB of shared memory
constexpr int C_WAVES = 4;                   // pass C's least waves of blocks
constexpr int MIN_LOG_L = 7;                 // transform lengths n1, n2: 2^7 .. 2^10
constexpr int MAX_LOG_L = 10;

// A transform of 2^log_l points runs its log_l stages in register groups:
// 7 = 4 + 3, 8 = 4 + 4, 9 = 3 + 3 + 3, 10 = 4 + 3 + 3.
__host__ __device__ constexpr int num_groups(int log_l) { return log_l <= 8 ? 2 : 3; }

__host__ __device__ constexpr int group_k(int log_l, int g) {
    return g == 0 ? (log_l == 9 ? 3 : 4) : (log_l == 8 ? 4 : 3);
}

// The index bits below group g: it runs the stages of half-size
// 2^(group_lo + k - 1) down to 2^group_lo.
__host__ __device__ constexpr int group_lo(int log_l, int g) {
    return g < 0 ? log_l : group_lo(log_l, g - 1) - group_k(log_l, g);
}

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
    return __brev(x) >> (32 - bits);
}

// Register group G of every transform of a tile of 2^LOG_T words, in K3's
// split (group_k) and block of THREADS threads (ntt_groups::run_group).
template <int LOG_L, int LOG_T, int G, bool COLS, class Load, class Store>
__device__ __forceinline__ void run_group(const uint64_t* __restrict__ tw, Load load,
                                          Store store) {
    ntt_groups::run_group<LOG_L, LOG_T, group_k(LOG_L, G), group_lo(LOG_L, G), THREADS, COLS>(
        tw, load, store);
}

// A: one (polynomial, group of C = 2^(13 - LOG_L) columns) per block; LOG_L = log n1.
template <int LOG_L>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
col_inverse_kernel(const uint64_t* __restrict__ values, uint64_t* __restrict__ scratch,
                   const uint64_t* __restrict__ tw1_inv, const uint64_t* __restrict__ t_inv,
                   int log_n2) {
    extern __shared__ uint64_t x[];
    constexpr int LOG_C = LOG_TILE - LOG_L, NG = num_groups(LOG_L);
    const int groups = 1 << (log_n2 - LOG_C);
    const int64_t base = ((int64_t)(blockIdx.x / groups) << (LOG_L + log_n2)) +
                         ((blockIdx.x % groups) << LOG_C);
    const int n2 = 1 << log_n2;
    const uint64_t* src = values + base;
    uint64_t* dst = scratch + base;
    const uint64_t* t = t_inv + ((blockIdx.x % groups) << LOG_C);
    auto sload = [&](int c, int i) { return x[(i << LOG_C) | c]; };
    auto sstore = [&](int c, int i, uint64_t v) { x[(i << LOG_C) | c] = v; };
    run_group<LOG_L, LOG_TILE, 0, true>(
        tw1_inv, [&](int c, int i) { return src[(int64_t)i * n2 + c]; }, sstore);
    __syncthreads();
    if constexpr (NG == 3) {
        run_group<LOG_L, LOG_TILE, 1, true>(tw1_inv, sload, sstore);
        __syncthreads();
    }
    run_group<LOG_L, LOG_TILE, NG - 1, true>(tw1_inv, sload, [&](int c, int i, uint64_t v) {
        const int64_t off = (int64_t)i * n2 + c;
        dst[off] = canon(mul_lazy(v, __ldg(&t[off])));
    });
}

// B: one (polynomial, group of R = 2^(13 - LOG_L) rows) per block; LOG_L =
// log n2.  Tile row r is scratch row rev_n1(r0 + r); rows padded by a word.
template <int LOG_L>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
row_inverse_kernel(const uint64_t* __restrict__ scratch, uint64_t* __restrict__ coeffs,
                   const uint64_t* __restrict__ tw2_inv, int log_n1) {
    extern __shared__ uint64_t x[];
    constexpr int LOG_R = LOG_TILE - LOG_L, NG = num_groups(LOG_L), STRIDE = (1 << LOG_L) + 1;
    const int groups = 1 << (log_n1 - LOG_R);
    const int64_t poly = blockIdx.x / groups;
    const int r0 = (blockIdx.x % groups) << LOG_R;
    const int64_t n1 = 1 << log_n1;
    const uint64_t* src = scratch + (poly << (log_n1 + LOG_L));
    uint64_t* dst = coeffs + (poly << (log_n1 + LOG_L)) + r0;
    auto sload = [&](int r, int i) { return x[r * STRIDE + i]; };
    auto sstore = [&](int r, int i, uint64_t v) { x[r * STRIDE + i] = v; };
    run_group<LOG_L, LOG_TILE, 0, false>(
        tw2_inv,
        [&](int r, int i) {
            return src[((int64_t)bitrev((unsigned)(r0 + r), log_n1) << LOG_L) + i];
        },
        sstore);
    __syncthreads();
    if constexpr (NG == 3) {
        run_group<LOG_L, LOG_TILE, 1, false>(tw2_inv, sload, sstore);
        __syncthreads();
    }
    run_group<LOG_L, LOG_TILE, NG - 1, false>(tw2_inv, sload, [&](int r, int i, uint64_t v) {
        dst[r + n1 * bitrev((unsigned)i, LOG_L)] = canon(v);
    });
}

// C: one (polynomial, group of C = 2^(12 - LOG_L) columns, group of
// 2^log_per cosets) per block, the coset groups of a tile in adjacent
// blocks; LOG_L = log n1.
template <int LOG_L>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
col_forward_kernel(const uint64_t* __restrict__ coeffs, uint64_t* __restrict__ lde,
                   const uint64_t* __restrict__ tw1_fwd, const uint64_t* __restrict__ coset_tw,
                   const uint64_t* __restrict__ scale_u, int log_n2, int rate_bits, int log_per) {
    extern __shared__ uint64_t sm[];
    uint64_t* cx = sm;                         // the coefficient tile
    uint64_t* x = sm + (1 << LOG_TILE_C);      // the work tile
    constexpr int LOG_C = LOG_TILE_C - LOG_L, NG = num_groups(LOG_L);
    const int log_cg = rate_bits - log_per;    // coset groups a tile
    const int groups = 1 << (log_n2 - LOG_C);
    const int kk0 = (blockIdx.x & ((1 << log_cg) - 1)) << log_per;
    const int64_t poly = (blockIdx.x >> log_cg) / groups;
    const int c0 = ((blockIdx.x >> log_cg) % groups) << LOG_C;
    const int n2 = 1 << log_n2, log_n = LOG_L + log_n2;
    const uint64_t* src = coeffs + (poly << log_n) + c0;
#pragma unroll
    for (int q = 0; q < (1 << LOG_TILE_C) / THREADS; ++q) {
        const int e = threadIdx.x + q * THREADS;
        cx[e] = src[(int64_t)(e >> LOG_C) * n2 + (e & ((1 << LOG_C) - 1))];
    }
    __syncthreads();
    auto sload = [&](int c, int i) { return x[(i << LOG_C) | c]; };
    auto sstore = [&](int c, int i, uint64_t v) { x[(i << LOG_C) | c] = v; };
#pragma unroll 1
    for (int kk = kk0; kk < kk0 + (1 << log_per); ++kk) {
        const uint64_t* u = scale_u + ((int64_t)kk << LOG_L);
        const uint64_t* t = coset_tw + ((int64_t)kk << log_n) + c0;
        uint64_t* dst = lde + (((poly << rate_bits) | kk) << log_n) + c0;
        run_group<LOG_L, LOG_TILE_C, 0, true>(
            tw1_fwd,
            [&](int c, int i) { return mul_lazy(cx[(i << LOG_C) | c], __ldg(&u[i])); },
            sstore);
        __syncthreads();
        if constexpr (NG == 3) {
            run_group<LOG_L, LOG_TILE_C, 1, true>(tw1_fwd, sload, sstore);
            __syncthreads();
        }
        run_group<LOG_L, LOG_TILE_C, NG - 1, true>(tw1_fwd, sload, [&](int c, int i, uint64_t v) {
            const int64_t off = (int64_t)i * n2 + c;
            dst[off] = canon(mul_lazy(v, __ldg(&t[off])));
        });
        __syncthreads();                       // the next coset rewrites the work tile
    }
}

// D: one (polynomial, coset block, group of R = 2^(13 - LOG_L) rows) per
// block, in place; LOG_L = log n2.  Rows padded by a word.
template <int LOG_L>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
row_forward_kernel(uint64_t* __restrict__ lde, const uint64_t* __restrict__ tw2_fwd, int log_n1) {
    extern __shared__ uint64_t x[];
    constexpr int LOG_R = LOG_TILE - LOG_L, NG = num_groups(LOG_L), STRIDE = (1 << LOG_L) + 1;
    const int groups = 1 << (log_n1 - LOG_R);
    uint64_t* rows = lde + ((int64_t)(blockIdx.x / groups) << (log_n1 + LOG_L)) +
                     ((int64_t)((blockIdx.x % groups) << LOG_R) << LOG_L);
    auto sload = [&](int r, int i) { return x[r * STRIDE + i]; };
    auto sstore = [&](int r, int i, uint64_t v) { x[r * STRIDE + i] = v; };
    run_group<LOG_L, LOG_TILE, 0, false>(
        tw2_fwd, [&](int r, int i) { return rows[(r << LOG_L) + i]; }, sstore);
    __syncthreads();
    if constexpr (NG == 3) {
        run_group<LOG_L, LOG_TILE, 1, false>(tw2_fwd, sload, sstore);
        __syncthreads();
    }
    run_group<LOG_L, LOG_TILE, NG - 1, false>(tw2_fwd, sload, [&](int r, int i, uint64_t v) {
        x[r * STRIDE + i] = canon(v);
    });
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (1 << LOG_TILE) / THREADS; ++q) {
        const int e = threadIdx.x + q * THREADS;
        rows[e] = x[(e >> LOG_L) * STRIDE + (e & ((1 << LOG_L) - 1))];
    }
}

// f(std::integral_constant<int, log_l>) for log_l in [MIN_LOG_L, MAX_LOG_L].
template <class F>
cudaError_t with_log_l(int log_l, F f) {
    switch (log_l) {
        case 7: return f(std::integral_constant<int, 7>{});
        case 8: return f(std::integral_constant<int, 8>{});
        case 9: return f(std::integral_constant<int, 9>{});
        case 10: return f(std::integral_constant<int, 10>{});
    }
    return cudaErrorInvalidValue;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// values, coeffs, scratch: device [batch, n]; lde: device [batch, n << rate_bits].
// tw1_inv/tw1_fwd: [n1 / 2] powers of w_n1^(-1) / w_n1; tw2_inv/tw2_fwd:
// [n2 / 2] powers of w_n2^(-1) / w_n2; t_inv: [n1, n2] with t_inv[j1][i2] =
// w_n^(-rev_n1(j1) * i2) / n; coset_tw: [2^rate, n1, n2] with
// coset_tw[kk][r1][j2] = v[kk][j2] * w_n^(rev_n1(r1) * j2); scale_u:
// [2^rate, n1], where u[kk][j1] * v[kk][j2] = s_k^(j1 * n2 + j2), s_k =
// shift * w_N^rev_rate(kk).  All u64 canonical.
// Requires 14 <= log_n1 + log_n2 <= 20, 7 <= log_n1, log_n2 <= 10, and
// rate_bits <= 6.
int p2t_lde_tiled_rev(const uint64_t* values, uint64_t* coeffs, uint64_t* lde, uint64_t* scratch,
                      const uint64_t* tw1_inv, const uint64_t* tw1_fwd, const uint64_t* tw2_inv,
                      const uint64_t* tw2_fwd, const uint64_t* t_inv, const uint64_t* coset_tw,
                      const uint64_t* scale_u, int64_t batch, int log_n1, int log_n2,
                      int rate_bits, void* stream) {
    const int log_n = log_n1 + log_n2;
    if (log_n < MIN_LOG_N || log_n > MAX_LOG_N || log_n1 < MIN_LOG_L || log_n2 < MIN_LOG_L ||
        log_n1 > MAX_LOG_L || log_n2 > MAX_LOG_L || rate_bits < 0 || rate_bits > 6)
        return (int)cudaErrorInvalidValue;
    if (batch <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const int tile = (int)sizeof(uint64_t) << LOG_TILE;
    const int tile_c = 2 * ((int)sizeof(uint64_t) << LOG_TILE_C);
    const int64_t tiles = batch << (log_n - LOG_TILE);          // per pass A, B: n / 8192 a polynomial
    cudaError_t err;
    err = with_log_l(log_n1, [&](auto l1) {
        constexpr int L1 = decltype(l1)::value;
        cudaError_t e = allow_smem(col_inverse_kernel<L1>, tile);
        if (e != cudaSuccess) return e;
        col_inverse_kernel<L1><<<(unsigned)tiles, THREADS, tile, s>>>(values, scratch, tw1_inv,
                                                                      t_inv, log_n2);
        return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
    err = with_log_l(log_n2, [&](auto l2) {
        constexpr int L2 = decltype(l2)::value;
        const int bytes = (int)sizeof(uint64_t) * ((1 << (LOG_TILE - L2)) * ((1 << L2) + 1));
        cudaError_t e = allow_smem(row_inverse_kernel<L2>, bytes);
        if (e != cudaSuccess) return e;
        row_inverse_kernel<L2><<<(unsigned)tiles, THREADS, bytes, s>>>(scratch, coeffs, tw2_inv,
                                                                       log_n1);
        return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
    // Pass C: the fewest coset groups a tile (most cosets from one load of
    // the tile) that still give C_WAVES waves of blocks.
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return (int)err;
    const int64_t tiles_c = batch << (log_n - LOG_TILE_C);
    int log_cg = 0;
    while (log_cg < rate_bits && (tiles_c << log_cg) < (int64_t)C_WAVES * BLOCKS_PER_SM * sms)
        ++log_cg;
    err = with_log_l(log_n1, [&](auto l1) {
        constexpr int L1 = decltype(l1)::value;
        cudaError_t e = allow_smem(col_forward_kernel<L1>, tile_c);
        if (e != cudaSuccess) return e;
        col_forward_kernel<L1><<<(unsigned)(tiles_c << log_cg), THREADS, tile_c, s>>>(
            coeffs, lde, tw1_fwd, coset_tw, scale_u, log_n2, rate_bits, rate_bits - log_cg);
        return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
    err = with_log_l(log_n2, [&](auto l2) {
        constexpr int L2 = decltype(l2)::value;
        const int bytes = (int)sizeof(uint64_t) * ((1 << (LOG_TILE - L2)) * ((1 << L2) + 1));
        cudaError_t e = allow_smem(row_forward_kernel<L2>, bytes);
        if (e != cudaSuccess) return e;
        row_forward_kernel<L2><<<(unsigned)(tiles << rate_bits), THREADS, bytes, s>>>(
            lde, tw2_fwd, log_n1);
        return cudaGetLastError();
    });
    return (int)err;
}

// K3's geometry, for tools that count its SASS per butterfly: out[0] =
// threads a block, out[1] and out[2] = log2 of the words of a tile of
// passes A, B, D and of pass C, out[3 + g] = the stages of register group g
// of a transform of 2^log_l points (group_k), 0 past its last group.
int p2t_lde_tiled_geometry(int log_l, int* out) {
    if (log_l < MIN_LOG_L || log_l > MAX_LOG_L) return (int)cudaErrorInvalidValue;
    out[0] = THREADS;
    out[1] = LOG_TILE;
    out[2] = LOG_TILE_C;
    for (int g = 0; g < 3; ++g) out[3 + g] = g < num_groups(log_l) ? group_k(log_l, g) : 0;
    return 0;
}

}  // extern "C"
