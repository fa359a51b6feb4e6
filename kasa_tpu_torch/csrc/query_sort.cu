// K12 query_sort: the join engine's sort of a batch's windows.
//
// Replaces kasa_tpu/match/join.py:225 sort_queries, a device lax.sort of
// the (M, L) int32 query limbs with the read id as payload (num_keys=L,
// not stable).  K12 sorts by (limbs..., read id), so the order among
// equal windows is fixed: a stable LSD radix sort over 8-bit digits, the
// read id's low rid_bits first, then limbs L-1 .. 0 (four digits of each
// non-negative 30-bit limb).  Each pass is three launches on the stream:
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
// The passes ping-pong between two buffer pairs: pass p reads the input
// (p = 0) or the pair pass p - 1 wrote, and writes pair a (p even) or b.
//
// Bound on the H100: bytes.  Every pass reads the elements twice (hist,
// scatter) and writes them once, 4 (L + 1) bytes each, and the scatter's
// writes go to 256 streams per block; the least the function must move
// is its input and its output once.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;             // elements per block and pass
constexpr int kWarps = kTile / 32;

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
    __shared__ int wcnt[kWarps][256];
    for (int i = threadIdx.x; i < kWarps * 256; i += blockDim.x)
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

}  // namespace

extern "C" int kasa_query_sort(
        const void* q, const void* rid, void* qa, void* ra, void* qb,
        void* rb, void* hist, long long M, int L, int rid_bits,
        void* stream) {
    // hist holds 256 * blocks + 256 int32: the rows, then the digits'
    // totals, which bases_kernel turns into their starts
    if (L < 1 || L > 5 || rid_bits < 0 || rid_bits > 31 || M < 0
            || M >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
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
    const int32_t* src_q = (const int32_t*)q;
    const int32_t* src_r = (const int32_t*)rid;
    for (int p = 0; p < passes; ++p) {
        int32_t* dq = (int32_t*)(p % 2 == 0 ? qa : qb);
        int32_t* dr = (int32_t*)(p % 2 == 0 ? ra : rb);
        hist_kernel<<<blocks, kTile, 0, s>>>(src_q, src_r, M, L, cols[p],
                                             shifts[p], (int32_t*)hist,
                                             blocks);
        int32_t* totals = (int32_t*)hist + 256LL * blocks;
        scan_kernel<<<256, kTile, 0, s>>>((int32_t*)hist, blocks, totals);
        bases_kernel<<<1, 256, 0, s>>>(totals);
        scatter_kernel<<<blocks, kTile, 0, s>>>(
            src_q, src_r, dq, dr, M, L, cols[p], shifts[p],
            (const int32_t*)hist, totals, blocks);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src_q = dq;
        src_r = dr;
    }
    return (int)cudaGetLastError();
}
