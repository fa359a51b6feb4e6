// Shared helpers of the kernels (kasa_tpu_torch/csrc/*.cu).
//
// Every kernel file exports plain C launchers: device pointers, sizes
// and the CUDA stream come in as arguments, the launcher queues the
// kernel(s) on that stream and returns cudaGetLastError(), which the
// Python wrapper (kasa_tpu_torch/kernels.py) turns into an exception.
// No launcher allocates or synchronises.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KASA_I32_MAX 2147483647

constexpr unsigned kFull = 0xffffffffu;
// the most cards a process keeps per-device host caches for
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned long long shfl_xor_t(
        unsigned long long v, int m) {
    return __shfl_xor_sync(kFull, v, m);
}

// 64-bit keys in ascending order
struct U64Cmp {
    __device__ __forceinline__ int operator()(unsigned long long a,
                                              unsigned long long b) const {
        return a < b ? -1 : (a > b ? 1 : 0);
    }
};

// Rank of this thread's flag among the flags of the block in thread
// order, plus the block's total, for a block of NWARPS full warps.
// Every thread of the block must call it (it synchronises twice).
template <int NWARPS>
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums,
                                          int* total) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    const int within = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
        const int s = warp_sums[w];
        before += (w < (int)warp) ? s : 0;
        tot += s;
    }
    __syncthreads();
    *total = tot;
    return before + within;
}

// Exclusive prefix sum of one int64 value per thread over a block of
// NTHREADS threads (Hillis-Steele in shared memory); returns the
// block total in *total.  Every thread must call it.
template <int NTHREADS>
__device__ __forceinline__ long long block_exclusive_scan(
        long long v, long long* buf, long long* total) {
    const int t = threadIdx.x;
    buf[t] = v;
    __syncthreads();
    for (int off = 1; off < NTHREADS; off <<= 1) {
        const long long add = (t >= off) ? buf[t - off] : 0;
        __syncthreads();
        buf[t] += add;
        __syncthreads();
    }
    const long long incl = buf[t];
    *total = buf[NTHREADS - 1];
    __syncthreads();
    return incl - v;
}

// Ascending bitonic sort of P keys (P a power of two) in shared memory
// by a block of NTHREADS threads.  Every thread must call it; it ends
// with the keys sorted and the block synchronised.
template <typename T, int NTHREADS>
__device__ __forceinline__ void block_bitonic_sort(T* keys, int P) {
    const int tid = threadIdx.x;
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < P; i += NTHREADS) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const T a = keys[i], b = keys[ixj];
                    const bool asc = (i & k) == 0;
                    if ((a > b) == asc) {
                        keys[i] = b;
                        keys[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// Row-wise index row < query over limbs from..L-1 (non-negative 30-bit
// int32 limbs, compared as int32 as kasa_tpu/ops/search.py:16-26 does).
template <int L>
__device__ __forceinline__ bool row_less(const int32_t* row,
                                         const int32_t* q, int from) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
        if (i < from) continue;
        if (row[i] != q[i]) return row[i] < q[i];
    }
    return false;
}

// Lower bound in [0, n] of the full key q in the sorted (n, L) index,
// through the classic tables (match/device.py StackedTables): the dense
// 2^20-bucket prefix table narrows limb 0 to one bucket, a bisect finds
// limb 0's lower bound in it, and, when limb 0 is present, a bisect over
// limbs 1..L-1 inside that limb-0 run (run_end) finishes it.  Both
// bisects run until lo == hi: no fixed step count, no clamped gather.
template <int L>
__device__ __forceinline__ long long lower_bound_full(
        const int32_t* idx, const int32_t* prefix, const int32_t* run_end,
        long long n, const int32_t* q) {
    const unsigned b = min((unsigned)q[0] >> 10, (1u << 20) - 1u);
    long long lo = prefix[b], hi = prefix[b + 1];
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (idx[mid * L] < q[0]) lo = mid + 1; else hi = mid;
    }
    if (lo < n && idx[lo * L] == q[0]) {
        hi = run_end[lo];
        while (lo < hi) {
            const long long mid = (lo + hi) >> 1;
            if (row_less<L>(idx + mid * L, q, 1)) lo = mid + 1;
            else hi = mid;
        }
    }
    return lo;
}

// K10's read-order head of a query (join_match.cu), which K11's read arm
// takes (join_scatter.cu): the taxon of its T = 1 levels + 1 in bits
// 0-14 (0 for none; S < 2^15), its first valid level lo in bits 15-19 and
// its first valid level of T > 1, hi, in bits 20-24 (numK <= 25); the
// plain versions' match/join.py pack_heads
__device__ __forceinline__ int32_t pack_head(int taxon, int lo, int hi) {
    return (taxon + 1) | (lo << 15) | (hi << 20);
}
__device__ __forceinline__ int head_taxon(int32_t h) {
    return (h & 0x7fff) - 1;
}
__device__ __forceinline__ int head_lo(int32_t h) { return (h >> 15) & 31; }
__device__ __forceinline__ int head_hi(int32_t h) { return (h >> 20) & 31; }

// The largest k at which a window is valid: the first '^' (letter 30) at
// a position >= min_k - 1 gives that position (valid k <= pos), none
// gives max_k.  The limb is picked by unrolled selects: a runtime index
// into q would move it to local memory.
template <int L>
__device__ __forceinline__ int valid_level(const int32_t* q, int min_k,
                                           int max_k) {
    for (int pos = min_k - 1; pos < max_k; ++pos) {
        int32_t limb = q[0];
#pragma unroll
        for (int i = 1; i < L; ++i)
            if (pos / 6 == i) limb = q[i];
        if (((limb >> (5 * (5 - pos % 6))) & 31) == 30) return pos;
    }
    return max_k;
}

// One compare-exchange stage within each lane's K elements of a warp
// bitonic sort: partner distance J < K, merge size kk.
template <int K, int J, typename T, typename Cmp>
__device__ __forceinline__ void lane_stage(T (&v)[K], int kk, int lane,
                                           const Cmp& cmp) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k & J) continue;
        const int c = cmp(v[k], v[k | J]);
        if (((lane * K + k) & kk) == 0 ? c > 0 : c < 0) {
            const T t = v[k];
            v[k] = v[k | J];
            v[k | J] = t;
        }
    }
}

// Ascending bitonic sort of the 32 * K elements a warp holds (K a power
// of two up to 32), lane l holding elements l * K .. l * K + K - 1 in v,
// by cmp (-1, 0, 1); shfl_xor_t(T, lanes) must exist for T.  Every lane
// must call it; no shared memory, no barrier (K5's short arm, K6's warp
// arm).  The merge and stage loops stay rolled (the stages across lanes
// take the distance at run time, the K element slots unrolled; the
// stages within a lane one instantiation per distance), which keeps the
// code, and nvcc's time, small at K = 32.
template <int K, typename T, typename Cmp>
__device__ __forceinline__ void warp_bitonic_sort(T (&v)[K],
                                                  const Cmp& cmp) {
    constexpr int kLogK = (K >= 2) + (K >= 4) + (K >= 8) + (K >= 16)
                          + (K >= 32);
    const int lane = threadIdx.x & 31;
#pragma unroll 1
    for (int a = 1; a <= kLogK + 5; ++a) {
        const int kk = 1 << a;
        // across lanes: the partner sits in lane ^ (j / K), at the same k
#pragma unroll 1
        for (int b = a - 1; b >= kLogK; --b) {
            const int j = 1 << b;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int i = lane * K + k;
                const T o = shfl_xor_t(v[k], j >> kLogK);
                const int c = cmp(o, v[k]);
                const bool small = ((i & j) == 0) == ((i & kk) == 0);
                if (small ? c < 0 : c > 0) v[k] = o;
            }
        }
        // within a lane: distances 2^(min(a, log K) - 1) .. 1
        const int top = (a < kLogK ? a : kLogK) - 1;
        if constexpr (K > 16)
            if (top >= 4) lane_stage<K, 16>(v, kk, lane, cmp);
        if constexpr (K > 8)
            if (top >= 3) lane_stage<K, 8>(v, kk, lane, cmp);
        if constexpr (K > 4)
            if (top >= 2) lane_stage<K, 4>(v, kk, lane, cmp);
        if constexpr (K > 2)
            if (top >= 1) lane_stage<K, 2>(v, kk, lane, cmp);
        if constexpr (K > 1)
            if (top >= 0) lane_stage<K, 1>(v, kk, lane, cmp);
    }
}
