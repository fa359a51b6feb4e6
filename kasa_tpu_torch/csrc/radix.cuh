// Stable LSD radix sorts over 8-bit digits, shared by the kernels that
// sort in global memory:
//   rows_radix_sort   multi-block passes over (M, L) int32 rows with an
//                     int32 payload column, sorted by (limbs..., payload
//                     low bits): K12 query_sort (the payload is the read
//                     id) and K13 sort_dedup (the taxid, all 32 bits);
//   seg_radix_sort    one block per segment of equal length, rows of C
//                     int32 sorted within their segment: the long arms
//                     of K3 turbo_reads (one read's slot keys) and K5
//                     dedup (one read's windows).
// Digits are read as unsigned: limbs and slot keys are non-negative, and
// a taxid is a uint32 carried in an int32.  Launchers queue their passes
// on the stream given and allocate nothing.
#pragma once

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// multi-block passes (K12, K13).  Each pass is three launches:
//   hist    per block of kTile elements, the 256-bin digit histogram,
//           stored digit-major (hist[d * blocks + b]);
//   scan    one block per digit: the exclusive scan of its row over the
//           blocks, in place, and the digit's total; then one block
//           turns the 256 totals into the digits' starts (their
//           exclusive scan);
//   scatter each element goes to its digit's start plus its row entry
//           plus its rank among the block's earlier elements of its
//           digit (warp peers by __match_any_sync, earlier warps by
//           per-warp digit counts in shared memory): stable, so the pass
//           keeps the order of the digits sorted before.

constexpr int kTile = 1024;             // elements per block and pass
constexpr int kTileWarps = kTile / 32;

__device__ __forceinline__ unsigned digit_of(const int32_t* q,
                                             const int32_t* rid, long long m,
                                             int L, int col, int shift) {
    const unsigned key = col < 0 ? (unsigned)rid[m]
                                 : (unsigned)q[m * L + col];
    return (key >> shift) & 255u;
}

__global__ void __launch_bounds__(kTile) hist_kernel(
        const int32_t* q, const int32_t* rid, long long M, int L, int col,
        int shift, int32_t* hist, int blocks) {
    __shared__ int h[256];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
    __syncthreads();
    const long long m = (long long)blockIdx.x * kTile + threadIdx.x;
    if (m < M) atomicAdd(&h[digit_of(q, rid, m, L, col, shift)], 1);
    __syncthreads();
    for (int d = threadIdx.x; d < 256; d += blockDim.x)
        hist[(long long)d * blocks + blockIdx.x] = h[d];
}

// exclusive scan of row blockIdx.x (`blocks` entries) of hist, in place;
// its total to totals[blockIdx.x]
__global__ void __launch_bounds__(kTile) scan_kernel(int32_t* hist,
                                                     int blocks,
                                                     int32_t* totals) {
    __shared__ long long buf[kTile];
    int32_t* row = hist + (long long)blockIdx.x * blocks;
    const int per = (blocks + kTile - 1) / kTile;
    const int lo = min((int)threadIdx.x * per, blocks);
    const int hi = min(lo + per, blocks);
    long long sum = 0;
    for (int i = lo; i < hi; ++i) sum += row[i];
    long long all;
    long long run = block_exclusive_scan<kTile>(sum, buf, &all);
    for (int i = lo; i < hi; ++i) {
        const int32_t v = row[i];
        row[i] = (int32_t)run;
        run += v;
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = (int32_t)all;
}

__global__ void __launch_bounds__(256) bases_kernel(int32_t* totals) {
    __shared__ long long buf[256];
    long long all;
    const long long start = block_exclusive_scan<256>(totals[threadIdx.x],
                                                      buf, &all);
    totals[threadIdx.x] = (int32_t)start;
}

__global__ void __launch_bounds__(kTile) scatter_kernel(
        const int32_t* q_in, const int32_t* rid_in, int32_t* q_out,
        int32_t* rid_out, long long M, int L, int col, int shift,
        const int32_t* hist, const int32_t* base, int blocks) {
    __shared__ int wcnt[kTileWarps][256];
    for (int i = threadIdx.x; i < kTileWarps * 256; i += blockDim.x)
        (&wcnt[0][0])[i] = 0;
    __syncthreads();
    const long long m = (long long)blockIdx.x * kTile + threadIdx.x;
    const bool live = m < M;
    // lanes past the end take digit 256, a value no element has
    const unsigned d = live ? digit_of(q_in, rid_in, m, L, col, shift)
                            : 256u;
    const unsigned lane = threadIdx.x & 31u;
    const int warp = threadIdx.x >> 5;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && lane == (unsigned)(__ffs(peers) - 1))
        wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (!live) return;
    int before = 0;
    for (int w = 0; w < warp; ++w) before += wcnt[w][d];
    const long long dst = (long long)base[d]
                          + hist[(long long)d * blocks + blockIdx.x]
                          + before + rank;
    for (int i = 0; i < L; ++i) q_out[dst * L + i] = q_in[m * L + i];
    rid_out[dst] = rid_in[m];
}

// Sorts (M, L) rows q with payload rid by (limbs 0..L-1, rid's low
// rid_bits bits): one pass per byte of the payload's rid_bits, then four
// per limb, from the last limb to the first.  Pass p writes (qa, ra) when
// p is even, else (qb, rb); the caller reads the pair of the last pass.
// hist holds 256 * blocks + 256 int32: the rows, then the digits'
// totals, which bases_kernel turns into their starts.
inline int rows_radix_sort(const int32_t* q, const int32_t* rid,
                           int32_t* qa, int32_t* ra, int32_t* qb,
                           int32_t* rb, int32_t* hist, long long M, int L,
                           int rid_bits, cudaStream_t s) {
    const int blocks = (int)((M + kTile - 1) / kTile);
    // (column, shift) of every pass, least significant digit first
    int cols[4 * 5 + 4], shifts[4 * 5 + 4], passes = 0;
    for (int sh = 0; sh < rid_bits; sh += 8) {
        cols[passes] = -1;
        shifts[passes++] = sh;
    }
    for (int c = L - 1; c >= 0; --c)
        for (int sh = 0; sh < 30; sh += 8) {
            cols[passes] = c;
            shifts[passes++] = sh;
        }
    const int32_t* src_q = q;
    const int32_t* src_r = rid;
    int32_t* totals = hist + 256LL * blocks;
    for (int p = 0; p < passes; ++p) {
        int32_t* dq = p % 2 == 0 ? qa : qb;
        int32_t* dr = p % 2 == 0 ? ra : rb;
        hist_kernel<<<blocks, kTile, 0, s>>>(src_q, src_r, M, L, cols[p],
                                             shifts[p], hist, blocks);
        scan_kernel<<<256, kTile, 0, s>>>(hist, blocks, totals);
        bases_kernel<<<1, 256, 0, s>>>(totals);
        scatter_kernel<<<blocks, kTile, 0, s>>>(
            src_q, src_r, dq, dr, M, L, cols[p], shifts[p], hist, totals,
            blocks);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src_q = dq;
        src_r = dr;
    }
    return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// segmented passes (the long arms of K3 and K5).  One block walks its
// segment: the segment's digit histogram and its exclusive scan in
// shared memory, then the rows tile by tile in order, each going to its
// digit's running start plus its rank among the tile's earlier rows of
// that digit (warp peers by __match_any_sync, earlier warps by per-warp
// counts), after which the tile's counts advance the running starts:
// stable.  No histogram leaves the block, so a pass is one launch and a
// batch of R reads is R blocks.

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;

template <int C>
__global__ void __launch_bounds__(kSegThreads) seg_radix_pass_kernel(
        const int32_t* __restrict__ in, int32_t* __restrict__ out,
        int seg_len, int col, int shift) {
    __shared__ int start[256];
    __shared__ int wcnt[kSegWarps][256];
    const int tid = threadIdx.x;
    const unsigned lane = tid & 31u;
    const int warp = tid >> 5;
    const long long base = (long long)blockIdx.x * seg_len;
    for (int i = tid; i < 256; i += kSegThreads) start[i] = 0;
    for (int i = tid; i < kSegWarps * 256; i += kSegThreads)
        (&wcnt[0][0])[i] = 0;
    __syncthreads();
    for (int i = tid; i < seg_len; i += kSegThreads)
        atomicAdd(&start[((unsigned)in[(base + i) * C + col] >> shift)
                         & 255u], 1);
    __syncthreads();
    if (tid == 0) {
        int run = 0;
        for (int d = 0; d < 256; ++d) {
            const int c = start[d];
            start[d] = run;
            run += c;
        }
    }
    __syncthreads();
    for (int t0 = 0; t0 < seg_len; t0 += kSegThreads) {
        const int i = t0 + tid;
        const bool live = i < seg_len;
        // lanes past the end take digit 256, a value no row has
        const unsigned d = live ? (((unsigned)in[(base + i) * C + col]
                                    >> shift) & 255u)
                                : 256u;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const bool leader = live && lane == (unsigned)(__ffs(peers) - 1);
        if (leader) wcnt[warp][d] = __popc(peers);
        __syncthreads();
        if (live) {
            int before = start[d];
            for (int w = 0; w < warp; ++w) before += wcnt[w][d];
            const long long dst = base + before + rank;
#pragma unroll
            for (int c = 0; c < C; ++c)
                out[dst * C + c] = in[(base + i) * C + c];
        }
        __syncthreads();
        if (leader) {
            atomicAdd(&start[d], __popc(peers));
            wcnt[warp][d] = 0;
        }
        __syncthreads();
    }
}

// Sorts each of nseg segments of seg_len rows of C int32 by `passes`
// digit passes (column, shift; least significant first).  Pass 0 reads
// `in`; pass p writes a when p is even, else b.  Returns the buffer of
// the last pass.
template <int C>
int32_t* seg_radix_sort(const int32_t* in, int32_t* a, int32_t* b,
                        int nseg, int seg_len, const int* cols,
                        const int* shifts, int passes, cudaStream_t st) {
    const int32_t* src = in;
    int32_t* dst = a;
    for (int p = 0; p < passes; ++p) {
        dst = p % 2 == 0 ? a : b;
        seg_radix_pass_kernel<C><<<nseg, kSegThreads, 0, st>>>(
            src, dst, seg_len, cols[p], shifts[p]);
        src = dst;
    }
    return dst;
}

}  // namespace
