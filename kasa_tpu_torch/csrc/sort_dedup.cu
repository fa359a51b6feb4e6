// K13 sort_dedup: the index build's sort of (k-mer, taxid) entries and
// the removal of exact duplicates.
//
// Replaces kasa_tpu/index/build.py:112 sort_dedup_device: (N, L) int32
// limbs (non-negative 30-bit values; L = 2 at highestK 12, 5 at 25) and
// (N,) taxids, a uint32 carried in an int32, sorted by (limb 0, ...,
// limb L-1, taxid), the taxid compared unsigned, and every entry equal to
// the one before it in all L + 1 columns dropped.  The result is unique,
// so any correct sort gives the same bytes.
//
// Design: radix.cuh's rows_radix_sort with the taxid as the payload
// column over all its 32 bits (K12's one-sweep passes: the taxid's
// digits, then each limb's from the last limb to the first; the sorted
// rows land in the buffer pair the pass count's parity names), then a
// compaction in three launches:
//   flags    per block of kTile entries, the number of entries that
//            differ from their predecessor (the first always does);
//   scan     one block: the exclusive scan of those counts over the
//            blocks and their total, Nu;
//   compact  each such entry goes to its block's start plus its rank
//            among the block's earlier such entries (block_rank).
//
// Bound on the H100: bytes.  The least the function moves is its input
// once and its output once, (N + Nu) * 4 (L + 1) bytes; every radix pass
// reads and writes the rows once more, the histogram launch reads them
// once, and the compaction reads them twice.
#include "radix.cuh"

namespace {

constexpr int kTile = 1024;             // entries per compaction block
constexpr int kTileWarps = kTile / 32;

// exclusive scan of the `blocks` entries of row blockIdx.x of hist, in
// place; its total to totals[blockIdx.x]
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

template <int L>
__device__ __forceinline__ bool differs(const int32_t* q, const int32_t* t,
                                        long long m) {
    if (m == 0) return true;
    bool d = t[m] != t[m - 1];
#pragma unroll
    for (int l = 0; l < L; ++l) d = d || q[m * L + l] != q[(m - 1) * L + l];
    return d;
}

template <int L>
__global__ void __launch_bounds__(kTile) flags_kernel(const int32_t* q,
                                                      const int32_t* t,
                                                      long long N,
                                                      int32_t* counts) {
    const long long m = (long long)blockIdx.x * kTile + threadIdx.x;
    const bool f = m < N && differs<L>(q, t, m);
    const int n = __syncthreads_count(f);
    if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

template <int L>
__global__ void __launch_bounds__(kTile) compact_kernel(
        const int32_t* q, const int32_t* t, long long N,
        const int32_t* starts, int32_t* q_out, int32_t* t_out) {
    __shared__ int warp_sums[kTileWarps];
    const long long m = (long long)blockIdx.x * kTile + threadIdx.x;
    const bool f = m < N && differs<L>(q, t, m);
    int tot;
    const int rank = block_rank<kTileWarps>(f, warp_sums, &tot);
    if (!f) return;
    const long long dst = (long long)starts[blockIdx.x] + rank;
#pragma unroll
    for (int l = 0; l < L; ++l) q_out[dst * L + l] = q[m * L + l];
    t_out[dst] = t[m];
}

template <int L>
int launch(const int32_t* limbs, const int32_t* tax, int32_t* qa,
           int32_t* ta, int32_t* qb, int32_t* tb, int32_t* hist,
           long long N, int32_t* q_out, int32_t* t_out, int32_t* nu,
           cudaStream_t s) {
    const int err = rows_radix_sort(limbs, tax, qa, ta, qb, tb, hist, N, L,
                                    32, s);
    if (err != 0) return err;
    // the last pass wrote (qa, ta) when the pass count is odd, else
    // (qb, tb); hist is free again
    const bool odd = rows_radix_passes(L, 32) % 2 != 0;
    const int32_t* sq = odd ? qa : qb;
    const int32_t* st = odd ? ta : tb;
    const int blocks = (int)((N + kTile - 1) / kTile);
    flags_kernel<L><<<blocks, kTile, 0, s>>>(sq, st, N, hist);
    scan_kernel<<<1, kTile, 0, s>>>(hist, blocks, nu);
    compact_kernel<L><<<blocks, kTile, 0, s>>>(sq, st, N, hist, q_out,
                                               t_out);
    return (int)cudaGetLastError();
}

}  // namespace

// -> the number of digit passes of a sort of (N, L) entries;
// *scratch_words: the int32 words of hist (the sort's scratch, then the
// compaction's block counts)
extern "C" int kasa_sort_dedup_plan(long long N, int L,
                                    long long* scratch_words) {
    const long long sort = rows_radix_scratch_words(N, L);
    const long long blocks = (N + kTile - 1) / kTile;
    *scratch_words = sort > blocks ? sort : blocks;
    return rows_radix_passes(L, 32);
}

extern "C" int kasa_sort_dedup(const void* limbs, const void* tax,
                               void* qa, void* ta, void* qb, void* tb,
                               void* hist, long long N, int L, void* q_out,
                               void* t_out, void* nu, void* stream) {
    // qa, qb: (N, L) and ta, tb: (N,) int32 scratch; hist:
    // kasa_sort_dedup_plan's words; q_out (N, L), t_out (N,): the first
    // *nu rows are the result
    if (L < 2 || L > 5 || N < 1 || N >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* q = (const int32_t*)limbs;
    const int32_t* t = (const int32_t*)tax;
    int32_t *a = (int32_t*)qa, *b = (int32_t*)qb, *h = (int32_t*)hist;
    int32_t *ra = (int32_t*)ta, *rb = (int32_t*)tb, *o = (int32_t*)q_out;
    int32_t *ot = (int32_t*)t_out, *n = (int32_t*)nu;
    switch (L) {
        case 2: return launch<2>(q, t, a, ra, b, rb, h, N, o, ot, n, s);
        case 3: return launch<3>(q, t, a, ra, b, rb, h, N, o, ot, n, s);
        case 4: return launch<4>(q, t, a, ra, b, rb, h, N, o, ot, n, s);
        default: return launch<5>(q, t, a, ra, b, rb, h, N, o, ot, n, s);
    }
}
