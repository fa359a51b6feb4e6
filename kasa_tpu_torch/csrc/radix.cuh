// Stable LSD radix sorts, shared by the kernels that sort in global
// memory:
//   rows_radix_sort   a one-sweep sort of (M, L) int32 rows with an int32
//                     payload column by (limbs..., payload low bits):
//                     K12 query_sort (the payload is the read id) and K13
//                     sort_dedup (the taxid, all 32 bits);
//   seg_radix_sort    one block per segment of equal length, rows of C
//                     int32 sorted within their segment: the long arms
//                     of K3 turbo_reads (one read's slot keys) and K14
//                     mesh_merge, and K5 dedup's global arm.
// Digits are read as unsigned: limbs and slot keys are non-negative, and
// a taxid is a uint32 carried in an int32.  Launchers queue their passes
// on the stream given and allocate nothing.
#pragma once

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// rows_radix_sort (K12, K13): the one-sweep LSD radix sort of Adinets and
// Merrill ("Onesweep", 2022), written out here.  A sort is
//   memset  the scratch: digit counts, tile counters, status words;
//   hist    one launch reads every row once (kHistRows rows a thread in
//           flight) and counts the digits of every pass in shared memory,
//           then adds them into the passes' global histograms, one atomic
//           per bin and block;
//   scan    one launch, a block per pass: its histogram becomes its
//           digits' starts;
//   pass    one launch per digit, least significant first.  A block takes
//           the next tile from an atomic counter (so every earlier tile
//           is running or done, and the look-back below only waits on
//           those), stages the tile's rows in shared memory (every load
//           in flight at once, through registers), counts its digits and
//           publishes the counts at once as 64-bit (tag, count) status
//           words, ranks the digits stably (warp-private counters over a
//           warp-striped layout, peers by ballots), looks back over the
//           earlier tiles' words for its digits' global offsets (an
//           inclusive prefix ends the walk, an aggregate adds to it and
//           walks on), publishes its inclusive prefixes, and writes the
//           tile in digit order: consecutive threads to consecutive
//           destinations, whole runs of a digit at a time.
// A status word's high half tags its pass p (2p + 1 aggregate, 2p + 2
// inclusive prefix, 0 not yet written), so one memset serves every pass;
// its low half is a count, below M < 2^31.  Bound on the H100: bytes,
// each pass reading and writing every row once.  Measured on the H100
// (chip_smoke.py's stage times), a pass is bound by latency rather than
// bandwidth: a block's phases run in turn, three to four blocks an SM.
// Digits are 8 bits: 10-bit digits take fewer passes but each cost about
// twice as much on the H100 (1,024 counters a warp, runs of ~3 rows a
// digit in a tile).

constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;
constexpr unsigned kDigitMask = kRadix - 1;
// one digit per thread of a pass
constexpr int kSweepThreads = kRadix;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kLimbPasses = (30 + kBits - 1) / kBits;
constexpr int kMaxPasses = (32 + kBits - 1) / kBits + 5 * kLimbPasses;
constexpr int kCounterWords = (kMaxPasses + 1) / 2 * 2;
constexpr int kHistRows = 4;
constexpr int kHistBlocksPerSM = 8;

// rows per thread of a pass's tile: at most 12, and at most 48 words of
// a row staged in registers (3,072 rows at L = 2, 2,048 at L = 5)
template <int L>
__host__ __device__ constexpr int sweep_items() {
    return 48 / (L + 1) < 12 ? 48 / (L + 1) : 12;
}
template <int L>
__host__ __device__ constexpr int sweep_tile() {
    return kSweepThreads * sweep_items<L>();
}

inline int sweep_tile_of(int L) {
    switch (L) {
        case 1: return sweep_tile<1>();
        case 2: return sweep_tile<2>();
        case 3: return sweep_tile<3>();
        case 4: return sweep_tile<4>();
        default: return sweep_tile<5>();
    }
}

// the digit passes, least significant first: the payload's low rid_bits
// bits, then each 30-bit limb from the last to the first.  A single limb
// narrower than 30 bits (key_bits, L = 1 and no payload digits only)
// takes only the passes its bits need: the histogram launch counts every
// pass of the limb, and the first passes' counts are those of the plan.
struct SweepPlan {
    int passes;
    int col[kMaxPasses];     // limb, or -1 for the payload
    int shift[kMaxPasses];
};

inline SweepPlan sweep_plan(int L, int rid_bits, int key_bits = 30) {
    SweepPlan p{};
    for (int sh = 0; sh < rid_bits; sh += kBits) {
        p.col[p.passes] = -1;
        p.shift[p.passes++] = sh;
    }
    const int top = L == 1 && rid_bits == 0 && key_bits > 0
                        && key_bits < 30 ? key_bits : kLimbPasses * kBits;
    for (int c = L - 1; c >= 0; --c)
        for (int sh = 0; sh < top; sh += kBits) {
            p.col[p.passes] = c;
            p.shift[p.passes++] = sh;
        }
    return p;
}

inline int rows_radix_passes(int L, int rid_bits, int key_bits = 30) {
    return sweep_plan(L, rid_bits, key_bits).passes;
}

// int32 words of rows_radix_sort's scratch: kMaxPasses x kRadix digit
// counts (then starts), kCounterWords tile counters, and kRadix 64-bit
// status words per tile
inline long long rows_radix_scratch_words(long long M, int L) {
    const long long tiles = (M + sweep_tile_of(L) - 1) / sweep_tile_of(L);
    return (long long)kMaxPasses * kRadix + kCounterWords
           + 2 * tiles * kRadix;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// The lanes of the warp whose digit (BITS bits) equals this lane's, among
// the valid lanes: one ballot per bit.  Every lane must call it.
template <int BITS>
__device__ __forceinline__ unsigned warp_peers(unsigned d, bool valid) {
    unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
        const bool bit = (d >> b) & 1u;
        const unsigned set = __ballot_sync(0xffffffffu, bit);
        peers &= bit ? set : ~set;
    }
    return peers;
}

// Exclusive prefix sum of one int per thread over a block of NT threads
// (warp shuffles, then the warps' sums), and the block's total; sums holds
// NT / 32 ints of shared memory.  Every thread must call it.
template <int NT>
__device__ __forceinline__ int block_scan_excl(int v, int* sums,
                                               int* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    int before = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        const int s = sums[w];
        before += w < warp ? s : 0;
        tot += s;
    }
    __syncthreads();
    *total = tot;
    return before + x - v;
}

// adds one row's digit d (valid rows only) to the histogram h; a warp
// whose rows share the digit (runs of one read id or taxid, a limb's top
// bits) adds once.  Every lane must call it.
__device__ __forceinline__ void count_digit(unsigned* h, unsigned d,
                                            bool valid, unsigned nvalid) {
    const unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
    if (__all_sync(0xffffffffu, !valid || d == d0)) {
        if ((threadIdx.x & 31u) == 0) atomicAdd(&h[d0], nvalid);
    } else if (valid) {
        atomicAdd(&h[d], 1u);
    }
}

// the digit counts of every pass: rid_passes of the payload, then
// kLimbPasses of each limb from the last to the first
template <int L>
__global__ void __launch_bounds__(kSweepThreads) sweep_hist_kernel(
        const int32_t* __restrict__ q, const int32_t* __restrict__ rid,
        long long M, int rid_passes, unsigned* __restrict__ ghist) {
    extern __shared__ unsigned hs[];           // passes x kRadix
    const int passes = rid_passes + L * kLimbPasses;
    for (int i = threadIdx.x; i < passes * kRadix; i += kSweepThreads)
        hs[i] = 0;
    __syncthreads();
    const unsigned lane = threadIdx.x & 31u;
    const long long stride =
        (long long)gridDim.x * kSweepThreads * kHistRows;
    // the loop test reads the warp's first row, so whole warps iterate
    for (long long m0 = (long long)blockIdx.x * kSweepThreads * kHistRows
                        + threadIdx.x;
         m0 - lane < M; m0 += stride) {
        int32_t rows[kHistRows][L];
        unsigned rids[kHistRows];
#pragma unroll
        for (int u = 0; u < kHistRows; ++u) {
            const long long m = m0 + (long long)u * kSweepThreads;
#pragma unroll
            for (int c = 0; c < L; ++c)
                rows[u][c] = m < M ? q[m * L + c] : 0;
            rids[u] = rid_passes > 0 && m < M ? (unsigned)rid[m] : 0u;
        }
#pragma unroll
        for (int u = 0; u < kHistRows; ++u) {
            const bool valid = m0 + (long long)u * kSweepThreads < M;
            const unsigned nvalid =
                __popc(__ballot_sync(0xffffffffu, valid));
            for (int p = 0; p < rid_passes; ++p)
                count_digit(hs + p * kRadix,
                            (rids[u] >> (p * kBits)) & kDigitMask, valid,
                            nvalid);
#pragma unroll
            for (int c = L - 1; c >= 0; --c)
#pragma unroll
                for (int k = 0; k < kLimbPasses; ++k)
                    count_digit(
                        hs + (rid_passes + (L - 1 - c) * kLimbPasses + k)
                             * kRadix,
                        ((unsigned)rows[u][c] >> (k * kBits)) & kDigitMask,
                        valid, nvalid);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < passes * kRadix; i += kSweepThreads)
        if (hs[i] != 0) atomicAdd(&ghist[i], hs[i]);
}

// each pass's digit counts -> the digits' starts, in place
__global__ void __launch_bounds__(kRadix) sweep_scan_kernel(
        unsigned* ghist) {
    __shared__ long long buf[kRadix];
    unsigned* h = ghist + (long long)blockIdx.x * kRadix;
    const unsigned c = h[threadIdx.x];
    long long all;
    const long long start = block_exclusive_scan<kRadix>(c, buf, &all);
    h[threadIdx.x] = (unsigned)start;
}

template <int L>
constexpr size_t sweep_pass_smem() {
    return (size_t)kRadix * 8                   // s_delta
           + (size_t)kSweepWarps * kRadix * 4   // s_wcnt
           + (size_t)kRadix * 4                 // s_start
           + (size_t)sweep_tile<L>() * (4 * L + 4 + 2 + 2);
}

// One digit pass of tile after tile; tag = 2p + 1 for pass p.
template <int L>
__global__ void __launch_bounds__(kSweepThreads) sweep_pass_kernel(
        const int32_t* __restrict__ q_in, const int32_t* __restrict__ rid_in,
        int32_t* __restrict__ q_out, int32_t* __restrict__ rid_out,
        long long M, int col, int shift, unsigned tag,
        const unsigned* __restrict__ starts, unsigned* tile_counter,
        unsigned long long* status) {
    constexpr int kItems = sweep_items<L>();
    constexpr int kTileRows = sweep_tile<L>();
    extern __shared__ __align__(16) unsigned char sweep_smem[];
    // global offset minus local start of each digit's run in this tile
    long long* s_delta = reinterpret_cast<long long*>(sweep_smem);
    unsigned* s_wcnt = reinterpret_cast<unsigned*>(s_delta + kRadix);
    unsigned* s_start = s_wcnt + kSweepWarps * kRadix;
    int32_t* s_q = reinterpret_cast<int32_t*>(s_start + kRadix);
    int32_t* s_rid = s_q + kTileRows * L;
    // the input row at each sorted position, and its digit
    unsigned short* s_src = reinterpret_cast<unsigned short*>(
        s_rid + kTileRows);
    unsigned short* s_dig = s_src + kTileRows;
    __shared__ unsigned s_tile;
    __shared__ int s_sums[kSweepWarps];
    __shared__ unsigned s_count[kRadix];       // the tile's digit counts
    const int tid = threadIdx.x;
    const unsigned lane = tid & 31u;
    const unsigned lt = (1u << lane) - 1u;
    const int warp = tid >> 5;

    if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
    for (int i = tid; i < kSweepWarps * kRadix; i += kSweepThreads)
        s_wcnt[i] = 0;
    for (int i = tid; i < kRadix; i += kSweepThreads) s_count[i] = 0;
    __syncthreads();
    const long long tile = s_tile;
    const long long base = tile * kTileRows;
    const int cnt = M - base < kTileRows ? (int)(M - base) : kTileRows;
    // stage the tile's rows, coalesced, every load issued before the
    // first store
    {
        int32_t vq[kItems * L], vr[kItems];
#pragma unroll
        for (int k = 0; k < kItems * L; ++k) {
            const int j = k * kSweepThreads + tid;
            vq[k] = j < cnt * L ? q_in[base * L + j] : 0;
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            const int j = k * kSweepThreads + tid;
            vr[k] = j < cnt ? rid_in[base + j] : 0;
        }
#pragma unroll
        for (int k = 0; k < kItems * L; ++k)
            s_q[k * kSweepThreads + tid] = vq[k];
#pragma unroll
        for (int k = 0; k < kItems; ++k)
            s_rid[k * kSweepThreads + tid] = vr[k];
    }
    __syncthreads();

    // warp w takes rows [w, w + 1) x 32 kItems, item by item: their
    // digits, counted for the tile and published before the ranking
    const int wbase = warp * 32 * kItems;
    unsigned dig[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const int p = wbase + i * 32 + (int)lane;
        const unsigned key = p >= cnt ? 0u
                             : col < 0 ? (unsigned)s_rid[p]
                                       : (unsigned)s_q[p * L + col];
        dig[i] = (key >> shift) & kDigitMask;
        if (p < cnt) atomicAdd(&s_count[dig[i]], 1u);
    }
    __syncthreads();
    st_relaxed(status + tile * kRadix + tid,
               ((unsigned long long)(tile == 0 ? tag + 1 : tag) << 32)
               | s_count[tid]);

    // rank: each row after its warp's earlier rows of its digit
    unsigned* wc = s_wcnt + warp * kRadix;
    unsigned rank[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const bool valid = wbase + i * 32 + (int)lane < cnt;
        const unsigned d = dig[i];
        const unsigned peers = warp_peers<kBits>(d, valid);
        const unsigned before = valid ? wc[d] : 0u;
        __syncwarp();
        if (valid && (peers & lt) == 0) wc[d] = before + __popc(peers);
        __syncwarp();
        rank[i] = before + __popc(peers & lt);
    }
    __syncthreads();

    // this thread's digit: the warps' exclusive offsets and the tile's
    // count
    const int d = tid;
    unsigned tcnt = 0;
#pragma unroll
    for (int w = 0; w < kSweepWarps; ++w) {
        const unsigned c = s_wcnt[w * kRadix + d];
        s_wcnt[w * kRadix + d] = tcnt;
        tcnt += c;
    }
    int total;
    const int start = block_scan_excl<kSweepThreads>((int)tcnt, s_sums,
                                                     &total);
    long long excl = 0;
    for (long long t = tile - 1; t >= 0; --t) {
        unsigned long long w;
        unsigned wtag;
        do {
            w = ld_relaxed(status + t * kRadix + d);
            wtag = (unsigned)(w >> 32);
        } while (wtag != tag && wtag != tag + 1);
        excl += (unsigned)w;
        if (wtag == tag + 1) break;
    }
    if (tile > 0)
        st_relaxed(status + tile * kRadix + d,
                   ((unsigned long long)(tag + 1) << 32)
                   | (unsigned long long)(excl + tcnt));
    s_start[d] = (unsigned)start;
    s_delta[d] = (long long)starts[d] + excl - start;
    __syncthreads();

    // the tile in digit order, in shared memory
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const int p = wbase + i * 32 + (int)lane;
        if (p < cnt) {
            const unsigned d = dig[i];
            const unsigned pos = s_start[d] + wc[d] + rank[i];
            s_src[pos] = (unsigned short)p;
            s_dig[pos] = (unsigned short)d;
        }
    }
    __syncthreads();

    // out: word j of the sorted tile to its run's place
#pragma unroll
    for (int k = 0; k < kItems * L; ++k) {
        const int j = k * kSweepThreads + tid;
        if (j < cnt * L) {
            const int po = j / L;
            const int c = j - po * L;
            q_out[(po + s_delta[s_dig[po]]) * L + c] = s_q[s_src[po] * L + c];
        }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int po = k * kSweepThreads + tid;
        if (po < cnt) rid_out[po + s_delta[s_dig[po]]] = s_rid[s_src[po]];
    }
}

inline int sweep_sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
                || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                          dev) != cudaSuccess
                || n <= 0)
            n = 132;
    }
    return n;
}

template <int L>
int sweep_sort(const int32_t* q, const int32_t* rid, int32_t* qa,
               int32_t* ra, int32_t* qb, int32_t* rb, int32_t* scratch,
               long long M, int rid_bits, cudaStream_t s,
               cudaEvent_t* marks, int key_bits) {
    const SweepPlan plan = sweep_plan(L, rid_bits, key_bits);
    const long long tiles = (M + sweep_tile<L>() - 1) / sweep_tile<L>();
    unsigned* ghist = reinterpret_cast<unsigned*>(scratch);
    unsigned* counters = ghist + kMaxPasses * kRadix;
    unsigned long long* status = reinterpret_cast<unsigned long long*>(
        counters + kCounterWords);
    if (marks) cudaEventRecord(marks[0], s);
    cudaError_t e = cudaMemsetAsync(
        scratch, 0, rows_radix_scratch_words(M, L) * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
    const int rid_passes = (rid_bits + kBits - 1) / kBits;
    const size_t hsmem = (size_t)(rid_passes + L * kLimbPasses) * kRadix
                         * sizeof(unsigned);
    if (hsmem > 48 * 1024) {
        e = cudaFuncSetAttribute(sweep_hist_kernel<L>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)hsmem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long rows = (long long)kSweepThreads * kHistRows;
    const long long want = (M + rows - 1) / rows;
    const long long most = (long long)sweep_sm_count() * kHistBlocksPerSM;
    const int hblocks = (int)(want < most ? want : most);
    sweep_hist_kernel<L><<<hblocks, kSweepThreads, hsmem, s>>>(
        q, rid, M, rid_passes, ghist);
    sweep_scan_kernel<<<plan.passes, kRadix, 0, s>>>(ghist);
    if (marks) cudaEventRecord(marks[1], s);
    // the kernel's static shared memory counts against the 48 KB default
    // too, so the limit is raised whatever the dynamic size
    constexpr size_t psmem = sweep_pass_smem<L>();
    e = cudaFuncSetAttribute(sweep_pass_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)psmem);
    if (e != cudaSuccess) return (int)e;
    const int32_t* src_q = q;
    const int32_t* src_r = rid;
    for (int p = 0; p < plan.passes; ++p) {
        int32_t* dq = p % 2 == 0 ? qa : qb;
        int32_t* dr = p % 2 == 0 ? ra : rb;
        sweep_pass_kernel<L><<<(unsigned)tiles, kSweepThreads, psmem, s>>>(
            src_q, src_r, dq, dr, M, plan.col[p], plan.shift[p],
            2u * p + 1u, ghist + p * kRadix, counters + p, status);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        if (marks) cudaEventRecord(marks[2 + p], s);
        src_q = dq;
        src_r = dr;
    }
    return (int)cudaSuccess;
}

// Sorts (M, L) rows q with payload rid by (limbs 0..L-1, rid's low
// rid_bits bits), stably: rows_radix_passes(L, rid_bits) passes, pass p
// writing (qa, ra) when p is even, else (qb, rb); the caller reads the
// pair of the last pass.  scratch holds rows_radix_scratch_words(M, L)
// int32 words.  marks, when given, are passes + 2 events, recorded before
// the memset, after the scan and after each pass.  key_bits: see
// sweep_plan.
inline int rows_radix_sort(const int32_t* q, const int32_t* rid,
                           int32_t* qa, int32_t* ra, int32_t* qb,
                           int32_t* rb, int32_t* scratch, long long M, int L,
                           int rid_bits, cudaStream_t s,
                           cudaEvent_t* marks = nullptr, int key_bits = 30) {
    switch (L) {
        case 1: return sweep_sort<1>(q, rid, qa, ra, qb, rb, scratch, M,
                                     rid_bits, s, marks, key_bits);
        case 2: return sweep_sort<2>(q, rid, qa, ra, qb, rb, scratch, M,
                                     rid_bits, s, marks, key_bits);
        case 3: return sweep_sort<3>(q, rid, qa, ra, qb, rb, scratch, M,
                                     rid_bits, s, marks, key_bits);
        case 4: return sweep_sort<4>(q, rid, qa, ra, qb, rb, scratch, M,
                                     rid_bits, s, marks, key_bits);
        default: return sweep_sort<5>(q, rid, qa, ra, qb, rb, scratch, M,
                                      rid_bits, s, marks, key_bits);
    }
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
