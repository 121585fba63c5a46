// Register groups of a decimation-in-frequency NTT, shared by the LDE
// kernels K2 (lde.cu) and K3 (lde_tiled.cu).
//
// A transform of 2^LOG_L points runs its stages as register groups: a
// group of K stages above the lowest B index bits holds 2^K elements of a
// transform in one thread's registers and runs its K stages there with
// lazy butterflies (goldilocks::dif_lazy: values stay any u64, made
// canonical once at the kernel's store).  Shared memory is used only
// between groups; the caller chooses the split of LOG_L into groups and the
// layout of its tiles.

#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace ntt_groups {

using namespace goldilocks;

// K DIF stages of a transform of length 2^LOG_L on v[0 .. 2^K): v[j] is its
// element (hi << (B + K)) | (j << B) | lo.  tw[q] = w^q (q < 2^(LOG_L - 1))
// for the transform's root w.  The stage of half-size m = 2^(B + t) pairs
// v[j] with v[j + 2^t] and multiplies by w_2m^(i mod m) = tw[(i mod m) <<
// (LOG_L - 1 - B - t)], i mod m = ((j mod 2^t) << B) | lo.  With B = 0 (lo
// = 0) the factor of j mod 2^t = 0 is 1 and is not multiplied.
template <int LOG_L, int K, int B>
__device__ __forceinline__ void radix(uint64_t (&v)[1 << K], const uint64_t* __restrict__ tw,
                                      int lo) {
#pragma unroll
    for (int t = K - 1; t >= 0; --t) {
#pragma unroll
        for (int q = 0; q < (1 << t); ++q) {
            const uint64_t w =
                (B == 0 && q == 0) ? 1 : __ldg(&tw[((q << B) | lo) << (LOG_L - 1 - B - t)]);
#pragma unroll
            for (int j = q; j < (1 << K); j += 2 << t) {
                if (B == 0 && q == 0)
                    dif_lazy(v[j], v[j + (1 << t)]);
                else
                    dif_lazy(v[j], v[j + (1 << t)], w);
            }
        }
    }
}

// The register group of K stages above B index bits of every transform of a
// tile of 2^LOG_T words, which holds 2^(LOG_T - LOG_L) transforms of
// 2^LOG_L points, in a block of THREADS threads.  Register group rg of the
// tile is thread rg % THREADS's (rg / THREADS)-th, in a loop of REPS trips
// (none when REPS = 1); it is split as (transform, lo, hi) from its low bits
// up in a column tile (COLS: consecutive threads on consecutive columns),
// as (lo, transform, hi) in a row tile.  load(tr, i) gives element i of
// transform tr; store(tr, i, v) takes it back.  A group that reads and
// writes the same shared words needs no barrier of its own: each thread
// writes only what it read.
template <int LOG_L, int LOG_T, int K, int B, int THREADS, bool COLS, class Load, class Store>
__device__ __forceinline__ void run_group(const uint64_t* __restrict__ tw, Load load,
                                          Store store) {
    constexpr int LOG_TR = LOG_T - LOG_L;
    constexpr int REPS = (1 << (LOG_T - K)) / THREADS;
    static_assert(REPS >= 1 && (1 << (LOG_T - K)) % THREADS == 0, "a tile must fill every thread");
#pragma unroll 1
    for (int q = 0; q < REPS; ++q) {
        const int rg = threadIdx.x + q * THREADS;
        int tr, lo, hi;
        if (COLS) {
            tr = rg & ((1 << LOG_TR) - 1);
            lo = (rg >> LOG_TR) & ((1 << B) - 1);
            hi = rg >> (LOG_TR + B);
        } else {
            lo = rg & ((1 << B) - 1);
            tr = (rg >> B) & ((1 << LOG_TR) - 1);
            hi = rg >> (B + LOG_TR);
        }
        const int i0 = (hi << (B + K)) | lo;
        uint64_t v[1 << K];
#pragma unroll
        for (int j = 0; j < (1 << K); ++j) v[j] = load(tr, i0 | (j << B));
        radix<LOG_L, K, B>(v, tw, lo);
#pragma unroll
        for (int j = 0; j < (1 << K); ++j) store(tr, i0 | (j << B), v[j]);
    }
}

}  // namespace ntt_groups
