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
