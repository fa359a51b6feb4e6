// K10 join_match: the join engine's per-level match of a sorted batch.
//
// Replaces kasa_tpu/match/join.py:175 _match_one_keff (one program per
// k level, each a fixed-step lexicographic bisect of the masked queries,
// kasa_tpu/ops/search.py:30 searchsorted_limbs) and join.py:189
// _letters_block (the 5-bit letters at positions min_k-1..max_k-1 whose
// '^' test the host turns into a cumulative validity, join.py:280-285).
// For every query m and every level ki (k = max_k - ki) it writes
//   matched[ki, m]  the query's k-prefix exists in the index,
//   g[ki, m]        its group id (0 where unmatched),
//   T[ki, m]        the group's distinct taxa (0 where unmatched),
//   start[ki, m]    the group's first taxon in d_tax[ki] (grp_start[0]
//                   where unmatched, as kasa_tpu gives it),
//   ok[ki, m]       no '^' at positions min_k-1 .. k-1.
// Every cell of the five, every time (the wrapper allocates them
// uninitialised).  Optionally (heads not null, for K11's read arm) each
// query's record at its position in the batch before K12 sorted it,
// pos[m] (a permutation of 0 .. M-1, so every record is written once).
// The levels nest: a query valid at level ki (matched and ok) is valid
// at every shallower level ki' > ki (a shorter prefix), and its group
// there holds the deeper group's entries, so T does not fall as ki grows
// and a T = 1 level's taxon is every T = 1 level's.  A query's adds are
// therefore
//   heads (M,) int32, 4 bytes (common.cuh pack_head): the taxon of its
//     T = 1 levels + 1 (d_tax[lo] at its first valid level lo, read here
//     in key order, where neighbours share their d_tax cells; 0 where
//     T > 1 at lo or no level is valid), lo, and hi = its first valid
//     level of T > 1 (numK where none): the T = 1 levels are [lo, hi),
//     the T > 1 levels [hi, numK).  The taxon takes 15 bits: heads exist
//     only where K11's read arm takes the batch, whose row of S float64
//     cells fits a block's shared memory (S < 29,049 on the H100), and
//     the wrapper refuses S past that;
//   wide_at (M,) int32: m, its row in the key-order outputs above, where
//     hi < numK (the wrapper fills the rest with -1: a coalesced fill
//     costs less than a scattered -1 for every query, PERF.md §6).
// 4 bytes a query, written in key order and then scattered to pos[m] by
// a second kernel (scatter_heads_kernel) that runs alone: scattered from
// the main kernel, 4- and 8-byte heads alike took 0.6 ms of the join
// batch's K10 (PERF.md §6); per-level records of 48 or 64 bytes took
// 1.9 and 1.66 ms.  K11 reads the T > 1 levels' T and start from the
// key-order outputs.
//
// kasa_tpu bisects once per level.  K10 takes ONE lower bound of the full
// key per query and decides every level from pos and pos - 1: k-prefix
// groups nest inside the sorted order, so the level-k group [a, b) of the
// query's prefix, where it exists, holds pos in [a, b], i.e. the entry at
// pos (pos < b) or at pos - 1 (pos == b > a); an absent prefix shows at
// neither.  Which entry of the group is found does not matter: all share
// the group id.
//
// Bound on the H100: memory latency and the bytes written.  The outputs
// are 14 * numK bytes a query, coalesced (level-major, query minor); the
// rest is gathers.  Design, one thread a query, blocks of 256 neighbours
// in the sorted batch:
//   search  a query's lower bound lies in its prefix bucket (the
//           2^20-bucket table on limb 0's top bits), so the lower bounds
//           of a block's queries lie in the rows from the bucket start of
//           its first query to the bucket end of its last: one load each
//           (the first design bisected both queries in memory first, a
//           chain of ~10 loads the whole block waited on, and lost to
//           the per-query search, PERF.md §6).  Those rows and the one
//           before are copied into shared memory with cp.async and each
//           query bisects the copy.  A block whose stretch passes
//           kStretchWords, or a query whose bucket lies outside its
//           block's (a batch out of key order), takes lower_bound_full
//           in memory (common.cuh: the bucket, limb 0's bisect, the
//           bisect of the limb-0 run), decided on the device (a 128-bit
//           index under an 8,192-read batch: ~11,000 rows a block at
//           L = 5, no block copies);
//   levels  in chunks of kChunk levels: every level's grp_id gather
//           issued, then every grp_start pair, then the stores, so that a
//           query waits out two round trips a chunk, not two a level (the
//           first design's stores through pointers that could alias kept
//           each level's loads behind the last level's stores); the level
//           masks sit in shared memory;
//   heads   the taxon's d_tax gather at lo, the head stored at m (in key
//           order), then scattered to pos[m] by scatter_heads_kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 25;
constexpr int kChunk = 8;              // levels whose gathers go out together
// int32 words of a block's index stretch: 4,094 rows at L = 2, 1,637 at
// L = 5 (a copy starts on a 16-byte boundary)
constexpr int kStretchWords = 8192;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// a bucket of the prefix table: limb 0's top 20 bits (lower_bound_full)
__device__ __forceinline__ unsigned prefix_bucket(int32_t q0) {
    return min((unsigned)q0 >> 10, (1u << 20) - 1u);
}

template <int L>
__global__ void __launch_bounds__(kThreads, 4) join_match_kernel(
        const int32_t* __restrict__ idx, const int32_t* __restrict__ grp_id,
        const int32_t* __restrict__ grp_start,
        const int32_t* __restrict__ masks, const int32_t* __restrict__ run_end,
        const int32_t* __restrict__ prefix, const int32_t* __restrict__ q,
        const int32_t* __restrict__ d_tax, long long n, long long gmax,
        long long tmax, long long M, int num_k,
        int min_k, int max_k, int stretch, uint8_t* __restrict__ matched,
        int32_t* __restrict__ g_out, int32_t* __restrict__ T_out,
        int32_t* __restrict__ start_out, uint8_t* __restrict__ ok_out,
        int32_t* __restrict__ keyed) {
    __shared__ __align__(16) int32_t srows[kStretchWords];
    __shared__ int32_t smask[kMaxLevels * L];
    __shared__ unsigned sbucket[2];        // the block's first, last bucket
    __shared__ long long sbound[2];        // their first row, last row + 1
    for (int i = threadIdx.x; i < num_k * L; i += kThreads)
        smask[i] = masks[i];
    const long long nw = n * L;
    for (long long base = (long long)blockIdx.x * kThreads; base < M;
         base += (long long)gridDim.x * kThreads) {
        const long long last = min(base + kThreads, M) - 1;
        const bool active = base + threadIdx.x <= last;
        // a thread past the batch's end searches the last query and
        // stores nothing
        const long long m = active ? base + threadIdx.x : last;
        int32_t qv[L];
#pragma unroll
        for (int i = 0; i < L; ++i) qv[i] = q[m * L + i];
        __syncthreads();           // the last round's reads of the copy
        if (stretch && (threadIdx.x == 0 || threadIdx.x == 32)) {
            const int j = threadIdx.x == 0 ? 0 : 1;
            const unsigned bk = prefix_bucket(q[(j == 0 ? base : last) * L]);
            sbucket[j] = bk;
            sbound[j] = prefix[bk + j];
        }
        __syncthreads();
        const long long blo = sbound[0], bhi = sbound[1];
        // rows [a, b]: the rows at pos and pos - 1 of every query between
        const long long a = max(blo - 1, 0LL), b = min(bhi, n - 1);
        const long long wa = (a * L) & ~3LL, w1 = (b + 1) * L;
        const bool copy = stretch && blo <= bhi
                          && ((w1 + 3) & ~3LL) - wa <= kStretchWords;
        if (copy) {
            for (long long w = wa + 4 * threadIdx.x; w < w1;
                 w += 4 * kThreads) {
                if (w + 4 <= nw) {
                    cp_async16(srows + (w - wa), idx + w);
                } else {
                    for (long long k = w; k < nw; ++k) srows[k - wa] = idx[k];
                }
            }
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        }
        __syncthreads();
        long long p;
        int32_t at[L], pr[L];
        const unsigned bq = prefix_bucket(qv[0]);
        if (copy && bq >= sbucket[0] && bq <= sbucket[1]) {
            long long lo = blo, hi = bhi;
            while (lo < hi) {
                const long long mid = (lo + hi) >> 1;
                if (row_less<L>(srows + (mid * L - wa), qv, 0)) lo = mid + 1;
                else hi = mid;
            }
            p = lo;
#pragma unroll
            for (int i = 0; i < L; ++i) {
                at[i] = p < n ? srows[p * L - wa + i] : 0;
                pr[i] = p > 0 ? srows[(p - 1) * L - wa + i] : 0;
            }
        } else {
            p = lower_bound_full<L>(idx, prefix, run_end, n, qv);
#pragma unroll
            for (int i = 0; i < L; ++i) {
                at[i] = p < n ? idx[p * L + i] : 0;
                pr[i] = p > 0 ? idx[(p - 1) * L + i] : 0;
            }
        }
        const int kv = valid_level<L>(qv, min_k, max_k);
        int lo = num_k, hi = num_k, t_lo = 0, s_lo = 0;
        for (int k0 = 0; k0 < num_k; k0 += kChunk) {
            int gg[kChunk], s0[kChunk], s1[kChunk];
            unsigned hit = 0;
            // every level's group: a gather from the entry found
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int ki = k0 + u;
                gg[u] = 0;
                if (ki >= num_k) continue;
                bool eq_at = p < n, eq_pr = p > 0;
#pragma unroll
                for (int i = 0; i < L; ++i) {
                    const int32_t mk = smask[ki * L + i];
                    const int32_t qm = qv[i] & mk;
                    eq_at = eq_at && ((at[i] & mk) == qm);
                    eq_pr = eq_pr && ((pr[i] & mk) == qm);
                }
                if (eq_at || eq_pr) {
                    hit |= 1u << u;
                    gg[u] = grp_id[ki * n + (eq_at ? p : p - 1)];
                }
            }
            // every level's group bounds
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int ki = k0 + u;
                if (ki >= num_k) continue;
                const int32_t* gs = grp_start + ki * gmax + gg[u];
                s0[u] = gs[0];
                s1[u] = gs[1];
            }
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int ki = k0 + u;
                if (ki >= num_k) continue;
                const bool h = (hit >> u) & 1u;
                const int t = h ? s1[u] - s0[u] : 0;
                const bool ok = (max_k - ki) <= kv;
                if (active) {
                    const long long o = ki * M + m;
                    matched[o] = h;
                    g_out[o] = gg[u];
                    T_out[o] = t;
                    start_out[o] = s0[u];
                    ok_out[o] = ok;
                }
                if (h && ok) {
                    if (lo == num_k) {
                        lo = ki;
                        t_lo = t;
                        s_lo = s0[u];
                    }
                    if (t > 1 && hi == num_k) hi = ki;
                }
            }
        }
        if (keyed != nullptr && active) {
            const int taxon = lo < num_k && t_lo == 1
                              ? d_tax[lo * tmax + s_lo] : -1;
            keyed[m] = pack_head(taxon, lo, hi);
        }
    }
}

// The heads in key order (keyed) to their queries' positions, and the
// key-order row of each query with T > 1 levels to wide_at: the
// scatter alone, its sources read once with the streaming hint, the
// heads stored with the L2 evict-last hint, so that a sector's eight
// heads tend to meet in L2 before it is written back (a sector written
// back in part costs a read of the rest; the hint took 0.06 ms off the
// join batch's K10, PERF.md §6)
__global__ void __launch_bounds__(kThreads) scatter_heads_kernel(
        const int32_t* __restrict__ keyed, const int32_t* __restrict__ pos,
        long long M, int num_k, int32_t* __restrict__ heads,
        int32_t* __restrict__ wide_at) {
    unsigned long long keep;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(keep));
    for (long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
         m < M; m += (long long)gridDim.x * kThreads) {
        const int32_t h = __ldcs(keyed + m);
        const int32_t d = __ldcs(pos + m);
        asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;"
                     :: "l"(heads + d), "r"(h), "l"(keep) : "memory");
        if (head_hi(h) < num_k) wide_at[d] = (int32_t)m;
    }
}

template <int L>
int launch(const int32_t* const* in, long long n, long long gmax,
           long long tmax, long long M, int num_k, int min_k, int max_k,
           int stretch, void* const* out, cudaStream_t stream) {
    long long blocks = (M + kThreads - 1) / kThreads;
    blocks = min(blocks, 1LL << 20);
    join_match_kernel<L><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], n, gmax,
        tmax, M, num_k, min_k, max_k, stretch, (uint8_t*)out[0],
        (int32_t*)out[1], (int32_t*)out[2], (int32_t*)out[3],
        (uint8_t*)out[4], (int32_t*)out[7]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || out[5] == nullptr) return (int)err;
    scatter_heads_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const int32_t*)out[7], in[8], M, num_k, (int32_t*)out[5],
        (int32_t*)out[6]);
    return (int)cudaGetLastError();
}

}  // namespace

// idx (n, L), grp_id (numK, n), grp_start (numK, gmax), masks (numK, L),
// run_end (n,), prefix (2^20 + 1,), q (M, L) sorted, int32; with heads
// d_tax (numK, tmax) and pos (M,) int32 too.  matched, ok (numK, M)
// uint8, g, T, start (numK, M) int32, every cell written; heads and
// wide_at (M,) int32 or null, every head written, wide_at where the
// query has T > 1 levels (the caller fills it with -1); keyed (M,)
// int32 scratch with heads (the heads in key order).
extern "C" int kasa_join_match(
        const void* idx, const void* grp_id, const void* grp_start,
        const void* masks, const void* run_end, const void* prefix,
        const void* q, const void* d_tax, const void* pos, long long n,
        long long gmax, long long tmax, long long M, int L, int num_k,
        int min_k, int max_k, void* matched, void* g, void* T, void* start,
        void* ok, void* heads, void* wide_at, void* keyed, void* stream) {
    if (L < 2 || L > 5 || num_k < 1 || num_k > kMaxLevels
            || max_k - min_k + 1 != num_k || min_k < 1 || gmax < 1
            || (heads != nullptr && (d_tax == nullptr || pos == nullptr
                                     || wide_at == nullptr
                                     || keyed == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (M <= 0 || n <= 0) return (int)cudaGetLastError();
    const int32_t* in[9] = {
        (const int32_t*)idx, (const int32_t*)grp_id,
        (const int32_t*)grp_start, (const int32_t*)masks,
        (const int32_t*)run_end, (const int32_t*)prefix, (const int32_t*)q,
        (const int32_t*)d_tax, (const int32_t*)pos};
    void* out[8] = {matched, g, T, start, ok, heads, wide_at,
                    heads != nullptr ? keyed : nullptr};
    // the copies are 16-byte cp.async from an index on a 16-byte boundary
    const int stretch = (reinterpret_cast<uintptr_t>(idx) & 15u) == 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch<2>(in, n, gmax, tmax, M, num_k, min_k, max_k,
                                 stretch, out, s);
        case 3: return launch<3>(in, n, gmax, tmax, M, num_k, min_k, max_k,
                                 stretch, out, s);
        case 4: return launch<4>(in, n, gmax, tmax, M, num_k, min_k, max_k,
                                 stretch, out, s);
        default: return launch<5>(in, n, gmax, tmax, M, num_k, min_k, max_k,
                                  stretch, out, s);
    }
}
