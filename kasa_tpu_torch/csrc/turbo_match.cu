// K2 turbo_match: per window, the full-key lower_bound in the index and
// the per-level slots.
//
// Replaces the "search" and "slots" stages of kasa_tpu/match/turbo.py
// :518 _turbo_core (lines 569-667): '^' validity per k level; the
// 24-bit router row, the sub-router row of a fat bucket and num_steps
// bisect steps over keys2 with a lexicographic compare over the L limbs
// (599-613); then the index rows at pos and pos-1 and, per k level, a
// masked prefix compare over the L limbs that yields either a T == 1
// slot key tax*8+ki or a multi-taxa payload psel*8+ki.  L = 2 for 64-bit
// indices (k <= 12), 3..5 for 128-bit ones (k <= 25); a level's mask is
// zero on the limbs past its k and partial on the limb holding letter k.
//
// Bound on the H100: device memory, in random accesses.  Per window: one
// 8-byte router row, a sub-router row (three windows in four on the
// smoke corpora), then the rows of one bucket: 8 on average, 0 to 60.
// The tables (hundreds of MB to GB at full size) do not fit the 50 MB
// L2, so nearly every one of these gathers is a device-memory access of
// a 32-byte sector or more.  The first design, one thread a window with
// num_steps (8 on the smoke corpora) dependent keys2 loads and two
// rowdat rows as scalar loads, took 11 round trips a window: its bisect
// alone took 0.087 of 0.217 ms on the default batch (PERF.md).
//
// Design: one thread a window for the router and the sub-router; then,
// in two rounds of 16 windows, the warp copies the rows [lo - 1, hi] of
// each window's bucket (up to kCap rows) from rowdat into shared memory,
// window by window, its lanes on neighbouring 16-byte chunks: coalesced
// requests, issued back to back by cp.async with no registers held.
// rowdat carries the limbs, so the rows at pos and pos - 1 are in the
// copy too.  Each thread then runs the reference's fixed-step bisect
// unchanged over its window's copy; a row outside the copy comes from
// memory, so every edge stays bit-identical to turbo_match_plain (the
// clamped gathers, pos = n + 1 for a window above every key of the last
// bucket).  A bucket wider than a copy takes its first steps from keys2
// in memory, as the first design did, until its range fits: at L = 2 a
// copy holds 32 rows (0.2 % of the smoke windows step first), at L = 3..5
// 8 rows of 20-28 bytes, since a copy of the whole bucket moved more
// bytes than the steps it saves.  The chain is router, sub-router,
// bucket at L = 2 (3 round trips); the copy is bound by its bytes (0.10
// of 0.17 ms, PERF.md).  The warp's (32, numK) slots are staged in
// shared memory and stored with neighbouring lanes on neighbouring
// words.  The limb count is a template parameter, so the limb arrays
// stay in registers.  The router and the sub-router read limbs 0 and 1
// only, as in kasa_tpu.
#include "common.cuh"

namespace {

// rows a window's copy may hold: at L = 2 nearly every whole bucket; the
// wider rows of L = 3..5 step from memory down to 8 rows first
template <int L>
constexpr int kCap = L == 2 ? 32 : 8;
constexpr int kMaxLevels = 8;      // numK of the staged slots
constexpr int kWarps = 2;          // warps a block
// A warp copies and bisects its windows in two rounds of 16, so that a
// pool of half the size lets twice the warps in flight for the router
// and the sub-router.  The pool: the 16-byte chunks of shared memory that
// the 16 copies of a round share, room for 16 rows of 16 bytes a window
// (the smoke batches' windows need 10 on average; at L = 3..5 a copy of
// 8 rows fits 15 chunks); a window that finds the pool full reads its
// rows from memory.
constexpr int kRounds = 2;
constexpr int kPool = 256;

// a count of ints known when the kernel is compiled
template <int N>
struct Ints {
    static constexpr int value = N;
};

struct MatchParams {
    int n, num_k, min_k, max_k, num_steps, sent;
    long long M;
};

template <int L>
__global__ void __launch_bounds__(kWarps * 32) turbo_match_kernel(
        const int32_t* __restrict__ q, const int2* __restrict__ router,
        const int2* __restrict__ sub2, const int32_t* __restrict__ keys2,
        const int32_t* __restrict__ rowdat,
        const int32_t* __restrict__ masks2, MatchParams p,
        int32_t* __restrict__ skey, int32_t* __restrict__ mpay) {
    constexpr int W = L + 2;   // ints a rowdat row
    extern __shared__ int4 smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int4* pool = smem + warp * kPool;
    const long long m0 = (long long)blockIdx.x * blockDim.x + warp * 32;
    const long long m = m0 + lane;
    const bool live = m < p.M;

    int qv[L];
#pragma unroll
    for (int i = 0; i < L; ++i) qv[i] = live ? __ldg(&q[m * L + i]) : 0;

    // rows < q, lexicographic over the limbs (kasa_tpu's lex_less)
    auto less_than_q = [&](const int* kk) {
        bool less = kk[L - 1] < qv[L - 1];
#pragma unroll
        for (int i = L - 2; i >= 0; --i)
            less = (kk[i] < qv[i]) || (kk[i] == qv[i] && less);
        return less;
    };

    // router (+ sub-router) bounds
    int lo = 0, hi = 0, step = 0;
    if (live) {
        const int q0 = qv[0], q1 = qv[1];
        const int2 rr = __ldg(&router[q0 >> 6]);
        lo = rr.x;
        hi = rr.y;
        if (rr.y < 0) {
            const int code = -rr.y;
            const int sub_base = code >> 5;
            const int s = code & 31;
            const int subkey = ((q0 & 0x3F) << 18) | (q1 >> 12);
            const int2 srow = __ldg(&sub2[sub_base + (subkey >> (24 - s))]);
            lo = srow.x;
            hi = srow.y;
        }
        // a bucket wider than a copy: its first steps from memory
        for (; step < p.num_steps && hi - lo + 2 > kCap<L>; ++step) {
            const int mid = (lo + hi) >> 1;
            const int32_t* kr = keys2 + (long long)min(mid, p.n - 1) * L;
            int kk[L];
#pragma unroll
            for (int i = 0; i < L; ++i) kk[i] = __ldg(&kr[i]);
            const bool less = less_than_q(kk);
            lo = less ? mid + 1 : lo;
            hi = less ? hi : mid;
        }
    }
    // the rows at pos and pos - 1, found in kRounds rounds: in each, the
    // copies of a part of the warp's windows, then their bisects
    int at[W], pv[W];
    int pos = 0;
    for (int h = 0; h < kRounds; ++h) {
        constexpr int part = 32 / kRounds;
        const bool turn = lane / part == h;
        // the copy of rows [cs, ce] (lo - 1 .. hi where they exist): the
        // 16-byte chunks [a0, a0 + 16 * n16) of rowdat around their bytes
        int cs = max(lo - 1, 0);
        int ce = live && turn ? min(min(hi, p.n - 1), cs + kCap<L> - 1)
                              : -1;
        const long long b0 = (long long)cs * W * 4;
        const long long a0 = b0 & ~15LL;
        int n16 = ce >= cs ? (int)((((long long)(ce + 1) * W * 4 + 15)
                                    & ~15LL) - a0) >> 4 : 0;
        int off16 = n16;   // the chunks of the lanes below, by a warp scan
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, off16, d);
            if (lane >= d) off16 += y;
        }
        off16 -= n16;
        if (off16 + n16 > kPool) {   // the pool is full: from memory
            n16 = 0;
            cs = 1;
            ce = 0;
        }
        // the warp copies the part's chunks, one window at a time, its
        // lanes on neighbouring chunks (a copy reads at most 15 bytes past
        // the last row, inside the allocator's 512-byte blocks)
        for (int w = h * part; w < (h + 1) * part; ++w) {
            const int wn = __shfl_sync(kFull, n16, w);
            const int wo = __shfl_sync(kFull, off16, w);
            const long long wa = __shfl_sync(kFull, a0, w);
            const char* src = reinterpret_cast<const char*>(rowdat) + wa;
            for (int k = lane; k < wn; k += 32) {
                const unsigned dst =
                    (unsigned)__cvta_generic_to_shared(pool + wo + k);
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                             :: "r"(dst), "l"(src + 16 * k));
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();

        // the first `cnt` ints of row r (0 <= r < n): from the copy, else
        // from memory (the limbs from keys2, a whole row from rowdat)
        const int32_t* mine = reinterpret_cast<const int32_t*>(pool + off16)
            + (int)(b0 - a0) / 4;
        auto row = [&](int r, int* out, auto cnt) {
            constexpr int c = decltype(cnt)::value;
            if (r >= cs && r <= ce) {
#pragma unroll
                for (int i = 0; i < c; ++i) out[i] = mine[(r - cs) * W + i];
            } else {
                const int32_t* src = c == L ? keys2 + (long long)r * L
                                            : rowdat + (long long)r * W;
#pragma unroll
                for (int i = 0; i < c; ++i) out[i] = __ldg(&src[i]);
            }
        };
        if (live && turn) {
            // the rest of the reference's num_steps steps, over the copy
            for (; step < p.num_steps; ++step) {
                const int mid = (lo + hi) >> 1;
                int kk[L];
                row(min(mid, p.n - 1), kk, Ints<L>{});
                const bool less = less_than_q(kk);
                lo = less ? mid + 1 : lo;
                hi = less ? hi : mid;
            }
            pos = lo;
            row(min(pos, p.n - 1), at, Ints<W>{});
            row(min(max(pos - 1, 0), p.n - 1), pv, Ints<W>{});
        }
        __syncwarp();   // this round's copies are read
    }
    int32_t* st_key = reinterpret_cast<int32_t*>(pool);
    int32_t* st_pay = st_key + 32 * kMaxLevels;
    if (live) {
        const int pos_c = min(pos, p.n - 1);
        const bool at_n = pos >= p.n;
        const int prev = max(pos - 1, 0);
        const bool prev_ok = pos > 0;
        // cumulative '^' (code 30) validity over letters min_k-1 .. k-1;
        // the letter at position lp sits in limb lp / 6
        unsigned ok_bits = 0;   // bit ki set: valid at k = max_k - ki
        bool ok = true;
        for (int lp = p.min_k - 1; lp < p.max_k; ++lp) {
            int limb = qv[0];
#pragma unroll
            for (int i = 1; i < L; ++i) limb = (lp / 6 == i) ? qv[i] : limb;
            const int shift = 5 * (5 - (lp % 6));
            ok = ok && (((limb >> shift) & 31) != 30);
            if (ok) ok_bits |= 1u << (p.max_k - (lp + 1));
        }
        for (int ki = 0; ki < p.num_k; ++ki) {
            bool hit_at = !at_n, hit_pv = prev_ok;
#pragma unroll
            for (int i = 0; i < L; ++i) {
                const int mk = __ldg(&masks2[ki * L + i]);
                const int qm = qv[i] & mk;
                hit_at = hit_at && ((at[i] & mk) == qm);
                hit_pv = hit_pv && ((pv[i] & mk) == qm);
            }
            const bool matched = (hit_at || hit_pv) && ((ok_bits >> ki) & 1u);
            const int tax = hit_pv ? pv[L] : at[L];
            const int tp = hit_pv ? pv[L + 1] : at[L + 1];
            const int tc = (tp >> (5 * ki)) & 31;
            const int psel = hit_pv ? prev : pos_c;
            st_key[lane * p.num_k + ki] =
                (matched && tc == 1) ? tax * 8 + ki : p.sent;
            st_pay[lane * p.num_k + ki] =
                (matched && tc >= 2) ? psel * 8 + ki : -1;
        }
    }
    __syncwarp();
    // the warp's 32 windows' slots are one run of the outputs
    const long long first = m0 * p.num_k;
    const long long end = p.M * p.num_k;
    for (int k = lane; k < 32 * p.num_k; k += 32) {
        if (first + k < end) {
            skey[first + k] = st_key[k];
            mpay[first + k] = st_pay[k];
        }
    }
}

template <int L>
int launch(const void* q, const void* router, const void* sub2,
           const void* keys2, const void* rowdat, const void* masks2,
           MatchParams p, void* skey, void* mpay, cudaStream_t st) {
    constexpr int threads = kWarps * 32;
    constexpr int smem = kWarps * kPool * 16;
    const long long blocks = (p.M + threads - 1) / threads;
    turbo_match_kernel<L><<<(unsigned)blocks, threads, smem, st>>>(
        (const int32_t*)q, (const int2*)router, (const int2*)sub2,
        (const int32_t*)keys2, (const int32_t*)rowdat,
        (const int32_t*)masks2, p, (int32_t*)skey, (int32_t*)mpay);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kasa_turbo_match(const void* q, const void* router,
                                const void* sub2, const void* keys2,
                                const void* rowdat, const void* masks2,
                                long long M, int L, int n, int num_k,
                                int min_k, int max_k, int num_steps,
                                int sent, void* skey, void* mpay,
                                void* stream) {
    MatchParams p{n, num_k, min_k, max_k, num_steps, sent, M};
    if (num_k < 1 || num_k > kMaxLevels || n < 1)
        return (int)cudaErrorInvalidValue;
    if (M <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch<2>(q, router, sub2, keys2, rowdat, masks2, p,
                                 skey, mpay, st);
        case 3: return launch<3>(q, router, sub2, keys2, rowdat, masks2, p,
                                 skey, mpay, st);
        case 4: return launch<4>(q, router, sub2, keys2, rowdat, masks2, p,
                                 skey, mpay, st);
        case 5: return launch<5>(q, router, sub2, keys2, rowdat, masks2, p,
                                 skey, mpay, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
