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
// Optionally (heads not null, for K11's read arm) each query's record
// at its position in the batch before K12 sorted it, pos[m].  The levels
// nest: a query valid at level ki (matched and ok) is valid at every
// shallower level ki' > ki (a shorter prefix), and its group there holds
// the deeper group's entries, so T does not fall as ki grows and a T = 1
// level's taxon is every T = 1 level's.  A query's adds are therefore
//   heads (M, 2) int32: x = the taxon of its T = 1 levels (d_tax[lo] at
//     its first valid level lo, read here in key order, where neighbours
//     share their d_tax cells), or -1 where T > 1 at lo or no level is
//     valid; y = lo | hi << 8, lo = its first valid level and hi = its
//     first valid level of T > 1 (numK where none): the T = 1 levels are
//     [lo, hi), the T > 1 levels [hi, numK);
//   wide_at (M,) int32: m, its row in the key-order outputs above, where
//     hi < numK (the caller fills the rest with -1).
// 8 bytes a query scattered (68 MB at M = 8.5 M, most of it merging in
// L2) where per-level records of 48 or 64 bytes cost K10 1.9 and 1.66 ms
// more than its key-order outputs alone on the join batch (PERF.md
// §6); K11 reads the T > 1 levels' T and start from those outputs.
//
// kasa_tpu bisects once per level.  K10 takes ONE lower bound of the full
// key per query (common.cuh lower_bound_full, as K9 does) and decides
// every level from pos and pos - 1: k-prefix groups nest inside the
// sorted order, so the level-k group [a, b) of the query's prefix, where
// it exists, holds pos in [a, b], i.e. the entry at pos (pos < b) or at
// pos - 1 (pos == b > a); an absent prefix shows at neither.  Which
// entry of the group is found does not matter: all share the group id.
//
// Bound on the H100: memory latency, not bytes.  Each query walks
// ~log2(bucket) + log2(run) dependent gathers of the index, then per
// level one grp_id and two grp_start gathers; the outputs are
// 14 * numK bytes per query, written coalesced (level-major, query
// minor).  One thread per query, grid-stride, blocks of 256 threads;
// neighbouring queries are neighbours in the sorted batch, so their
// bisects walk the same index rows through L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
    const int32_t* idx;        // (n, L) sorted index
    const int32_t* grp_id;     // (numK, n)
    const int32_t* grp_start;  // (numK, gmax)
    const int32_t* masks;      // (numK, L)
    const int32_t* run_end;    // (n,)
    const int32_t* prefix;     // (2^20 + 1,)
    const int32_t* q;          // (M, L) queries
    const int32_t* d_tax;      // (numK, tmax), with heads
    const int32_t* pos;        // (M,) original positions, with heads
    long long n, gmax, tmax, M;
    int num_k, min_k, max_k;
    uint8_t* matched;          // (numK, M)
    int32_t* g;                // (numK, M)
    int32_t* T;                // (numK, M)
    int32_t* start;            // (numK, M)
    uint8_t* ok;               // (numK, M)
    int2* heads;               // (M,) or null
    int32_t* wide_at;          // (M,), with heads
};

template <int L>
__global__ void __launch_bounds__(kThreads) join_match_kernel(Params p) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         m < p.M; m += stride) {
        int32_t q[L];
#pragma unroll
        for (int i = 0; i < L; ++i) q[i] = p.q[m * L + i];
        const int kv = valid_level<L>(q, p.min_k, p.max_k);
        const long long pos = lower_bound_full<L>(p.idx, p.prefix,
                                                  p.run_end, p.n, q);
        int32_t at[L], pr[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
            at[i] = pos < p.n ? p.idx[pos * L + i] : 0;
            pr[i] = pos > 0 ? p.idx[(pos - 1) * L + i] : 0;
        }
        int lo = p.num_k, hi = p.num_k;
        int32_t taxon = -1;
        for (int ki = 0; ki < p.num_k; ++ki) {
            bool eq_at = pos < p.n, eq_pr = pos > 0;
#pragma unroll
            for (int i = 0; i < L; ++i) {
                const int32_t mk = p.masks[ki * L + i];
                const int32_t qm = q[i] & mk;
                eq_at = eq_at && ((at[i] & mk) == qm);
                eq_pr = eq_pr && ((pr[i] & mk) == qm);
            }
            const bool hit = eq_at || eq_pr;
            const long long e = eq_at ? pos : pos - 1;
            const long long g = hit ? p.grp_id[ki * p.n + e] : 0;
            const int32_t* gs = p.grp_start + ki * p.gmax + g;
            const int ts = gs[0];
            const long long o = ki * p.M + m;
            p.matched[o] = hit;
            p.g[o] = (int32_t)g;
            p.T[o] = hit ? gs[1] - ts : 0;
            p.start[o] = ts;
            const bool ok = (p.max_k - ki) <= kv;
            p.ok[o] = ok;
            if (hit && ok) {
                const int t = gs[1] - ts;
                if (lo == p.num_k) {
                    lo = ki;
                    if (t == 1 && p.heads != nullptr)
                        taxon = p.d_tax[ki * p.tmax + ts];
                }
                if (t > 1 && hi == p.num_k) hi = ki;
            }
        }
        if (p.heads != nullptr) {
            const long long dst = p.pos[m];
            p.heads[dst] = make_int2(taxon, lo | (hi << 8));
            if (hi < p.num_k) p.wide_at[dst] = (int32_t)m;
        }
    }
}

template <int L>
int launch(const Params& p, cudaStream_t stream) {
    long long blocks = (p.M + kThreads - 1) / kThreads;
    blocks = min(blocks, 1LL << 20);
    join_match_kernel<L><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kasa_join_match(
        const void* idx, const void* grp_id, const void* grp_start,
        const void* masks, const void* run_end, const void* prefix,
        const void* q, const void* d_tax, const void* pos, long long n,
        long long gmax, long long tmax, long long M, int L, int num_k,
        int min_k, int max_k, void* matched, void* g, void* T, void* start,
        void* ok, void* heads, void* wide_at, void* stream) {
    if (L < 2 || L > 5 || num_k < 1 || num_k > 25
            || max_k - min_k + 1 != num_k || min_k < 1 || gmax < 1
            || (heads != nullptr && (d_tax == nullptr || pos == nullptr
                                     || wide_at == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (M <= 0 || n <= 0) return (int)cudaGetLastError();
    Params p{(const int32_t*)idx, (const int32_t*)grp_id,
             (const int32_t*)grp_start, (const int32_t*)masks,
             (const int32_t*)run_end, (const int32_t*)prefix,
             (const int32_t*)q, (const int32_t*)d_tax, (const int32_t*)pos,
             n, gmax, tmax, M, num_k, min_k, max_k, (uint8_t*)matched,
             (int32_t*)g, (int32_t*)T, (int32_t*)start, (uint8_t*)ok,
             (int2*)heads, (int32_t*)wide_at};
    cudaStream_t s = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch<2>(p, s);
        case 3: return launch<3>(p, s);
        case 4: return launch<4>(p, s);
        default: return launch<5>(p, s);
    }
}
