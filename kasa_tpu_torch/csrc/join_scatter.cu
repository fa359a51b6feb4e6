// K11 join_scatter: the join engine's score scatter.
//
// Replaces kasa_tpu/match/join.py:200 _score_scatter: every occurrence
// valid at level ki (matched and no '^', from K10) adds w(k) * (1/T),
// the float32 value kasa_tpu scatters (join.py:327-331), to its read's
// score row for each of its group's T taxa d_tax[ki][start .. start+T).
//
// kasa_tpu runs one program per level over a padded slot array of
// p_hat = next power of two of the level's (occurrence, taxon) pairs and
// finds each slot's occurrence by a search of an int32 cumsum: XLA needs
// static shapes.  K11 needs neither, and has two arms, picked by
// kernels.join_scatter_arm:
//
//   reads   (kasa_join_scatter_reads) the occurrences in read order: K12
//           carries each query's position in the batch, and K10 writes
//           each query's head at that position (join_match.cu: the taxon
//           of its T = 1 levels, the range of those levels [lo, hi) and
//           where its T > 1 levels [hi, numK) begin; for a query with T > 1
//           levels, its row in K10's key-order outputs).  The batch's
//           read ids ascend (encode_batch's layout), so a read's heads
//           are one run; seg_kernel finds where each run starts.  One
//           block per read over a persistent grid, as K9's local arm: the
//           read's row of S cells in shared memory, the block's threads
//           taking its queries; a query's T = 1 levels add one term (the
//           sum of their w(k)) to one taxon, the warp's adds combined per
//           taxon first (one vote when the warp holds one taxon, else
//           __match_any_sync and a tree of shuffles); its T > 1 levels
//           read T and start from K10's key-order outputs, and the warp's
//           groups of a level are laid end to end and their taxa spread
//           over the lanes, 32 at a time, so that the random d_tax loads
//           of a round are in flight together.  The row is written once
//           to the float32 output, zeros included: no (R, S) float64
//           buffer, no fill, no rounding pass.  Needs 8 * S bytes of
//           shared memory a block.
//   global  (kasa_join_scatter, the first design) the occurrences in key
//           order, one thread per (level, occurrence) walking its T taxa,
//           all levels in one launch, with 64-bit offsets: float64
//           atomics into an (R, S) buffer that the wrapper zeroes and
//           rounds to float32 once.  For batches whose read ids do not
//           ascend (-e: the host dedup drops positions) or whose row
//           passes the block's shared memory.
//
// Accumulation: a long read adds the same w(k)/T thousands of times to
// one cell, and float32 adds of a constant drift one way (K9 measured
// 9e-5 relative on a 24 k-window read, PERF.md): both arms add in
// float64 and round each cell to float32 once, within the contract (rtol
// 2e-5) of the exact sum.
//
// Bound on the H100: bytes and atomics.  The function's own bytes are
// the level flags, T, start and read id of every occurrence (the read
// arm: its records), the d_tax cells of the matched groups and the
// (R, S) score rows.  The global arm's adds of one group's occurrences
// land on distinct reads' rows in device memory; the read arm's in the
// read's row in shared memory, where its T > 1 groups read their d_tax
// runs without the key order's locality.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReadThreads = 512;     // most threads of a read-arm block

__global__ void __launch_bounds__(kThreads) join_scatter_kernel(
        const uint8_t* valid, const int32_t* T, const int32_t* start,
        const int32_t* read_ids, const int32_t* d_tax, const float* weights,
        long long M, long long tmax, int num_k, int S, double* scores) {
    const long long total = (long long)num_k * M;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         o < total; o += stride) {
        if (!valid[o]) continue;
        const int ki = (int)(o / M);
        const long long m = o - (long long)ki * M;
        const int t = T[o];
        const float val = weights[ki] * (1.0f / (float)t);
        const int32_t* taxa = d_tax + (long long)ki * tmax + start[o];
        double* srow = scores + (long long)read_ids[m] * S;
        for (int j = 0; j < t; ++j) atomicAdd(srow + taxa[j], (double)val);
    }
}

// ---------------------------------------------------------------------
// read arm

// seg[r] = the first record whose read id is >= r, for r in [0, R], of
// read ids that ascend: thread m writes the reads r with
// read_ids[m-1] < r <= read_ids[m] (none below record 0, R above the
// last), so each r is written once.
__global__ void seg_kernel(const int32_t* read_ids, long long M, int R,
                           long long* seg) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m == 0) seg[R + 1] = 0;      // the read arm's ticket counter
    if (m > M) return;
    const long long a = m == 0 ? -1 : (long long)read_ids[m - 1];
    const long long b = m == M ? R : min((long long)read_ids[m], (long long)R);
    for (long long r = max(a + 1, 0LL); r <= b; ++r) seg[r] = m;
}

constexpr int kMaxLevels = 25;
constexpr int kPre = 8;               // levels whose T > 1 groups load at once

// The T = 1 adds of a warp, every lane calling: the lane's taxon tax (-1
// for none) and its term v, combined per taxon before one add (one vote
// when the warp holds one taxon, else __match_any_sync and a tree).
__device__ __forceinline__ void add_one(double* srow, int tax, double v) {
    const unsigned lane = threadIdx.x & 31u;
    const int top = __reduce_max_sync(kFull, tax);
    if (top < 0) return;
    bool lead;
    if (__all_sync(kFull, tax < 0 || tax == top)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(kFull, v, off);
        tax = top;
        lead = lane == 0;
    } else {
        // the lanes of each taxon sum their terms by a log-step tree over
        // their ranks, the lowest peer ending with the sum
        const unsigned peers = __match_any_sync(kFull, tax);
        const unsigned below = peers & ((1u << lane) - 1u);
        unsigned rest = peers & (0xfffffffeu << lane);
        int rank = __popc(below);
        while (__any_sync(kFull, rest != 0u)) {
            const int next = __ffs(rest);
            const int src = next ? next - 1 : (int)lane;
            const double o = __shfl_sync(kFull, v, src);
            if (next) v += o;
            rest &= ~__ballot_sync(kFull, rank & 1);
            rank >>= 1;
        }
        lead = tax >= 0 && below == 0u;
    }
    if (lead) atomicAdd(srow + tax, v);
}

// One T > 1 level of the warp, every lane calling: the lane's group (its
// start a in d_tax[ki], dtk, and its t taxa; t = 0 for none).  The
// warp's groups are laid end to end (an exclusive scan of t over the
// lanes) and each lane takes every 32nd of their taxa: its group is the
// last lane whose start is at most its place (a bisect by shuffles), so
// every d_tax load of a round is in flight at once, and four rounds' loads
// go before their adds (a round waits ~4,800 cycles on its loads, random
// over the level's d_tax, PERF.md §6).  (Combining a round's adds per
// taxon, as the T = 1 adds are, cost more than it saved: the lanes' taxa
// are mostly distinct; laying the groups out over the whole block, so
// that one warp's many groups did not hold the block at its barrier,
// cost more too, PERF.md §6.)
__device__ __forceinline__ void add_wide(double* srow, const int32_t* dtk,
                                         float w, int a, int t) {
    const int lane = threadIdx.x & 31;
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    const int W = __shfl_sync(kFull, incl, 31);
    const int excl = incl - t;
    // four rounds' loads in flight before their adds
    for (int k0 = 0; k0 < W; k0 += 4 * 32) {
        int tx[4];
        double vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int k = k0 + 32 * u + lane;
            int g = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1) {
                const int e = __shfl_sync(kFull, excl, g + step);
                if (e <= k) g += step;
            }
            const int ts = __shfl_sync(kFull, a, g);
            const int tt = __shfl_sync(kFull, t, g);
            const int eg = __shfl_sync(kFull, excl, g);
            tx[u] = k < W ? dtk[ts + k - eg] : -1;
            vv[u] = (double)(w * (1.0f / (float)tt));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (tx[u] >= 0) atomicAdd(srow + tx[u], vv[u]);
    }
}

__global__ void __launch_bounds__(kReadThreads) reads_kernel(
        const int32_t* __restrict__ heads,
        const int32_t* __restrict__ wide_at,
        const int32_t* __restrict__ T, const int32_t* __restrict__ start,
        const long long* __restrict__ seg, const int32_t* __restrict__ d_tax,
        const float* __restrict__ weights, long long M, long long tmax,
        int num_k, int S, int R, float* __restrict__ scores) {
    extern __shared__ double srow[];     // the block's read's row
    __shared__ float lev[kMaxLevels];    // the levels' weights
    for (int i = threadIdx.x; i < num_k; i += blockDim.x) lev[i] = weights[i];
    for (int i = threadIdx.x; i < S; i += blockDim.x) srow[i] = 0.0;
    __syncthreads();
    // the blocks take reads from a ticket counter (seg[R + 1]): the reads
    // with many T > 1 groups take several times the others' time, and a
    // fixed share left some blocks far behind.  A read's bounds and its
    // first heads come while the one before writes its row: a read's
    // time is a chain of dependent loads (its bounds, heads, rows in K10's
    // outputs, T and start, d_tax), and only a dozen reads an SM are in
    // flight
    __shared__ long long s_ticket;
    unsigned long long* tickets =
        reinterpret_cast<unsigned long long*>(const_cast<long long*>(seg))
        + R + 1;
    const int32_t none = pack_head(-1, num_k, num_k);
    if (threadIdx.x == 0) s_ticket = (long long)atomicAdd(tickets, 1ull);
    __syncthreads();
    long long r = s_ticket, s = 0, e = 0;
    if (r < R) {
        s = seg[r];
        e = seg[r + 1];
    }
    int32_t first = r < R && s + threadIdx.x < e ? heads[s + threadIdx.x]
                                                 : none;
    while (r < R) {
        // the next read's ticket, read by all after the barrier below
        long long ticket = 0;
        if (threadIdx.x == 0) ticket = (long long)atomicAdd(tickets, 1ull);
        // whole warps step together: the bounds are the block's
        for (long long base = s; base < e; base += blockDim.x) {
            const long long m = base + threadIdx.x;
            const bool active = m < e;
            const int32_t h = base == s ? first : active ? heads[m] : none;
            const int tax = head_taxon(h), lo = head_lo(h), hi = head_hi(h);
            // the T = 1 levels [lo, hi), one taxon: one term, their w(k)
            // summed in float64
            double v = 0.0;
            if (tax >= 0)
                for (int ki = lo; ki < hi; ++ki) v += (double)lev[ki];
            add_one(srow, tax, v);
            // the T > 1 levels [hi, numK), their T and start from K10's
            // key-order outputs at the query's row there (the first kPre
            // levels' loaded at once)
            const int row = hi < num_k ? wide_at[m] : -1;
            const int kmin = __reduce_min_sync(kFull, hi);
            int pa[kPre], pt[kPre];
#pragma unroll
            for (int u = 0; u < kPre; ++u) {
                pa[u] = 0;
                pt[u] = 0;
                if (row >= 0 && u >= hi && u < num_k) {
                    pa[u] = start[u * M + row];
                    pt[u] = T[u * M + row];
                }
            }
#pragma unroll
            for (int u = 0; u < kPre; ++u)
                if (u >= kmin && u < num_k)
                    add_wide(srow, d_tax + u * tmax, lev[u], pa[u], pt[u]);
            for (int ki = max(kmin, kPre); ki < num_k; ++ki) {
                int a = 0, t = 0;
                if (row >= 0 && ki >= hi) {
                    a = start[ki * M + row];
                    t = T[ki * M + row];
                }
                add_wide(srow, d_tax + ki * tmax, lev[ki], a, t);
            }
        }
        if (threadIdx.x == 0) s_ticket = ticket;
        __syncthreads();
        const long long rn = s_ticket;
        long long sn = 0, en = 0;
        if (rn < R) {
            sn = seg[rn];
            en = seg[rn + 1];
        }
        first = rn < R && sn + threadIdx.x < en ? heads[sn + threadIdx.x]
                                                : none;
        float* out = scores + r * S;
        for (int c = threadIdx.x; c < S; c += blockDim.x) {
            out[c] = (float)srow[c];
            srow[c] = 0.0;
        }
        __syncthreads();
        r = rn;
        s = sn;
        e = en;
    }
}

}  // namespace

extern "C" int kasa_join_scatter(
        const void* valid, const void* T, const void* start,
        const void* read_ids, const void* d_tax, const void* weights,
        long long M, long long tmax, int num_k, int S, void* scores,
        void* stream) {
    if (num_k < 1 || S < 1 || tmax < 0) return (int)cudaErrorInvalidValue;
    if (M <= 0) return (int)cudaGetLastError();
    long long blocks = ((long long)num_k * M + kThreads - 1) / kThreads;
    blocks = min(blocks, 1LL << 20);
    join_scatter_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)valid, (const int32_t*)T, (const int32_t*)start,
        (const int32_t*)read_ids, (const int32_t*)d_tax,
        (const float*)weights, M, tmax, num_k, S, (double*)scores);
    return (int)cudaGetLastError();
}

// The read arm: heads and wide_at (M,) int32 from K10 in the
// batch's own order, T and start (numK, M) int32, K10's key-order
// outputs; read_ids (M,) of the batch's order, ascending; seg (R + 1,)
// int64 scratch (and a ticket counter after it); scores (R, S) float32,
// written whole.  sms: the card's
// multiprocessors (the persistent grid).
extern "C" int kasa_join_scatter_reads(
        const void* heads, const void* wide_at, const void* T,
        const void* start, const void* read_ids, const void* d_tax,
        const void* weights, long long M, long long tmax, int num_k, int S,
        int R, int sms, void* seg, void* scores, void* stream) {
    if (num_k < 1 || num_k > kMaxLevels || S < 1 || tmax < 0 || R < 0
            || sms < 1)
        return (int)cudaErrorInvalidValue;
    if (R == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    seg_kernel<<<(unsigned)((M + 256) / 256), 256, 0, st>>>(
        (const int32_t*)read_ids, M, R, (long long*)seg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // a block as wide as a read's records, in whole warps
    const long long per_read = (M + R - 1) / R;
    const int threads = (int)min(max((per_read + 31) / 32 * 32, 64LL),
                                 (long long)kReadThreads);
    const size_t smem = (size_t)8 * S;
    // the attribute and the occupancy of the last shape on each card,
    // kept: the host queries cost more than the kernel on a small batch.
    // The caches are per device (the attribute is set per device) and
    // not thread-safe: one host thread launches on a card at a time.
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    static size_t set_smem[kMaxDevices], occ_smem[kMaxDevices];
    static int occ_threads[kMaxDevices], per_sm[kMaxDevices];
    if (smem > set_smem[dev]) {
        err = cudaFuncSetAttribute(
            reads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        set_smem[dev] = smem;
    }
    if (threads != occ_threads[dev] || smem != occ_smem[dev]) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[dev], reads_kernel, threads, smem);
        if (err != cudaSuccess) return (int)err;
        occ_threads[dev] = threads;
        occ_smem[dev] = smem;
    }
    // a persistent grid: each block zeroes its row once
    const long long blocks = max(
        min((long long)R, (long long)max(per_sm[dev], 1) * sms), 1LL);
    reads_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        (const int32_t*)heads, (const int32_t*)wide_at, (const int32_t*)T,
        (const int32_t*)start, (const long long*)seg, (const int32_t*)d_tax,
        (const float*)weights, M, tmax, num_k, S, R, (float*)scores);
    return (int)cudaGetLastError();
}
