// K8 tiered_pass: one index chunk searched by the windows routed to it.
//
// Replaces kasa_tpu/match/tiered.py:201 tiered_chunk_pass.  kasa_tpu
// runs it in fixed passes of PASS_CAP windows only to keep its compiled
// shapes fixed; here one launch takes all of a chunk's routed windows,
// one thread per window, with kasa_tpu's arithmetic and clamps:
//   - pos of the fixed num_steps bisect over the chunk's padded rowdat
//     ((pad, 4) int32 [l0, l1, tax, tpack], pad rows INT32_MAX) with
//     min(mid, n-1) (234-240), found from the prefix table below, then
//     the rows at pos and pos-1 (both gathered clamped to n-1);
//   - per level, the at/prev hit test under the level's prefix masks
//     (a full-limb mask compares the raw limb), prev winning when it
//     hits (255-275), T = the level's 5-bit field of tpack;
//   - T == 1: the slot key tax*8+ki stored at skey[pos, ki] (every other
//     level of a routed window gets I32_MAX); a plain store, since each
//     window has exactly one owning chunk;
//   - T > TMAX: the read's big flag (a store of 1; the host adds those
//     groups);
//   - 2 <= T <= TMAX: the msteps bisect over the level's slice of mstart
//     for the rightmost multi-group start <= the hit row, with its act
//     guard and mp-1 clamps (281-299), the group's d_tax4 row from mrow,
//     and the expansion of its ceil(T/4) taxa rows (-1 tail sentinels):
//     atomicAdd of w(k) * (1/T) into sflat[read * S + tax] and of 1/T
//     into cflat[k * S + tax] (313-344).
// The search: a per-chunk prefix table of limb 0 (tiered_prefix_kernel,
// built on the card once per chunk upload and kept beside the chunk in
// the device cache: match/tiered.py), 2^20 buckets over the span of the
// chunk's own limb-0 values, narrows each window's bisect to its bucket
// (a few rows), which runs to convergence; its lower bound is the fixed
// bisect's pos whenever num_steps covers the chunk (bit length of n
// steps, which kasa_tpu's step count for the padded chunk always gives;
// the wrapper refuses fewer), and a window above every row takes the
// fixed bisect's end for that path (n, or n + 1 when steps remain:
// p.above, from the launcher), so skey and big are bit-identical.
// A lane expands its own group's rows only.  (kasa_tpu's while loop runs
// every lane of a pass until the largest T of the pass is done, so a
// lane with a smaller group also adds the taxa of the rows after its
// own, which belong to the next multi groups; the port does not repeat
// that: ROADMAP.md, Queue 3.)  The float sums differ from kasa_tpu's by
// the order of the atomics only: each lane adds its own terms, as
// kasa_tpu's and the plain version's float32 sums do.  Combining the
// lanes of one read's cells first (K9's local arm) lost here: slower on
// the 4-chunk batch, and its fewer, larger float32 adds drift away from
// the plain version's sums of single terms (PERF.md).
//
// Bound on the H100: dependent random gathers.  Per window the prefix
// entry and ~log2(bucket) rowdat rows of 16 bytes (the chunk, 134 MB at
// 8.4 M entries, does not stay in the 50 MB L2), two more rows, and for
// a multi hit msteps mstart entries, a mrow entry and up to 8 taxa rows.
// Before the table the fixed bisect took 80 % of K8's time on the
// 4-chunk batch (PERF.md).  The least bytes are the distinct 32-byte
// sectors these gathers touch plus the routed windows and the slot row
// written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrefixBits = 20;            // 2^20 buckets a chunk

struct PassParams {
    long long lo, hi;
    int n, mp, dr, num_k, msteps, full0, full1, S, kpr, tmax;
    int above;    // the fixed bisect's pos for a window above every row
};

// The chunk's buckets: limb 0 from base, the chunk's first, in steps of
// 2^shift, the least shift that puts its last real row (pad rows hold
// INT32_MAX, above every limb) in bucket 2^kPrefixBits - 1 or below.
// pfx[b] = the first row whose limb 0 is >= base + (b << shift), for b
// in [0, 2^kPrefixBits], then base and shift: one thread a bucket, each
// finding the real rows' end and its bucket's start by lower bounds over
// the rows (neighbouring buckets walk the same rows).
__global__ void tiered_prefix_kernel(const int4* __restrict__ rowdat, int n,
                                     int32_t* __restrict__ pfx) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b > (1 << kPrefixBits)) return;
    // the chunk's real rows end at the first pad row (limb 0 >= 2^30)
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (int)(((long long)lo + hi) >> 1);
        if (__ldg(&rowdat[mid]).x < (1 << 30)) lo = mid + 1; else hi = mid;
    }
    const int nreal = lo;
    const long long base = nreal ? __ldg(&rowdat[0]).x : 0;
    const long long span = nreal ? __ldg(&rowdat[nreal - 1]).x - base : 0;
    int shift = 0;
    while ((span >> shift) >= (1 << kPrefixBits)) ++shift;
    const long long key = base + ((long long)b << shift);
    lo = 0;
    hi = n;
    while (lo < hi) {
        const int mid = (int)(((long long)lo + hi) >> 1);
        if (__ldg(&rowdat[mid]).x < key) lo = mid + 1; else hi = mid;
    }
    pfx[b] = lo;
    if (b == 0) {
        pfx[(1 << kPrefixBits) + 1] = (int)base;
        pfx[(1 << kPrefixBits) + 2] = shift;
    }
}

__global__ void tiered_pass_kernel(const int4* __restrict__ rowdat,
                                   const int32_t* __restrict__ mstart,
                                   const int32_t* __restrict__ mrow,
                                   const int32_t* __restrict__ moff,
                                   const int4* __restrict__ d_tax4,
                                   const float* __restrict__ weights,
                                   const int2* __restrict__ masks,
                                   const int2* __restrict__ qr,
                                   const int32_t* __restrict__ vbr,
                                   const int32_t* __restrict__ posr,
                                   const int32_t* __restrict__ pfx,
                                   PassParams p,
                                   int32_t* __restrict__ skey,
                                   float* __restrict__ sflat,
                                   float* __restrict__ cflat,
                                   int32_t* __restrict__ big) {
    const long long g = p.lo + (long long)blockIdx.x * blockDim.x
                        + threadIdx.x;
    if (g >= p.hi) return;
    const int2 q = __ldg(&qr[g]);
    const int vb = __ldg(&vbr[g]);
    const int ps = __ldg(&posr[g]);
    const long long rid = ps / p.kpr;

    const long long base = __ldg(&pfx[(1 << kPrefixBits) + 1]);
    const int shift = __ldg(&pfx[(1 << kPrefixBits) + 2]);
    const long long d = max((long long)q.x - base, 0LL) >> shift;
    const int b = (int)min(d, (long long)(1 << kPrefixBits) - 1);
    int lo = __ldg(&pfx[b]), hi = __ldg(&pfx[b + 1]);
    while (lo < hi) {
        const int mid = (int)(((long long)lo + hi) >> 1);
        const int4 kk = __ldg(&rowdat[mid]);
        const bool less = kk.x < q.x || (kk.x == q.x && kk.y < q.y);
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    const int pos = lo == p.n ? p.above : lo;
    const int pos_c = min(pos, p.n - 1);
    const bool at_n = pos >= p.n;
    const int prev = max(pos - 1, 0);
    const int4 at = __ldg(&rowdat[pos_c]);
    // a window above every key ends at pos = n + 1 (the fixed step
    // count): its prev row is gathered clamped to n - 1, as JAX's gather
    // clamps, while psel keeps prev = n
    const int4 pv = __ldg(&rowdat[min(prev, p.n - 1)]);
    const bool prev_ok = pos > 0;

    bool big_hit = false;
    for (int ki = 0; ki < p.num_k; ++ki) {
        bool hit_at = !at_n, hit_pv = prev_ok;
        const int2 mk = __ldg(&masks[ki]);
        if (mk.x != 0) {
            if (mk.x == p.full0) {
                hit_at = hit_at && at.x == q.x;
                hit_pv = hit_pv && pv.x == q.x;
            } else {
                const int qm = q.x & mk.x;
                hit_at = hit_at && (at.x & mk.x) == qm;
                hit_pv = hit_pv && (pv.x & mk.x) == qm;
            }
        }
        if (mk.y != 0) {
            if (mk.y == p.full1) {
                hit_at = hit_at && at.y == q.y;
                hit_pv = hit_pv && pv.y == q.y;
            } else {
                const int qm = q.y & mk.y;
                hit_at = hit_at && (at.y & mk.y) == qm;
                hit_pv = hit_pv && (pv.y & mk.y) == qm;
            }
        }
        const bool matched = (hit_at || hit_pv) && ((vb >> ki) & 1);
        const int tax = hit_pv ? pv.z : at.z;
        const int tp = hit_pv ? pv.w : at.w;
        const int psel = hit_pv ? prev : pos_c;
        const int tc = matched ? (tp >> (5 * ki)) & 31 : 0;
        skey[(long long)ps * p.num_k + ki] =
            tc == 1 ? tax * 8 + ki : KASA_I32_MAX;
        big_hit = big_hit || tc > p.tmax;
        if (tc < 2 || tc > p.tmax) continue;

        // the group's taxa rows: the rightmost multi-group start <= psel
        // in this level's slice of mstart
        const int mbase = __ldg(&moff[ki]);
        int mlo = 0, mhi = __ldg(&moff[ki + 1]) - mbase;
        for (int step = 0; step < p.msteps; ++step) {
            const bool act = mlo < mhi;
            const int mid = (mlo + mhi) >> 1;
            const bool le = __ldg(&mstart[min(mbase + mid, p.mp - 1)])
                            <= psel;
            mlo = (act && le) ? mid + 1 : mlo;
            mhi = (act && !le) ? mid : mhi;
        }
        const int rowb = __ldg(&mrow[min(mbase + max(mlo - 1, 0),
                                         p.mp - 1)]);
        const float inv = 1.0f / (float)tc;
        const float val = __ldg(&weights[ki]) * inv;
        float* srow = sflat + rid * p.S;
        float* crow = cflat + (long long)ki * p.S;
        const int nrow = (tc + 3) >> 2;
        for (int j = 0; j < nrow; ++j) {
            const int4 t = __ldg(&d_tax4[min(rowb + j, p.dr - 1)]);
            const int tt[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                if (tt[c] >= 0) {
                    atomicAdd(&srow[tt[c]], val);
                    atomicAdd(&crow[tt[c]], inv);
                }
            }
        }
    }
    if (big_hit) big[rid] = 1;
}

}  // namespace

// The prefix table (2^20 + 3,) int32 of a chunk's (n, 4) rowdat.
extern "C" int kasa_tiered_prefix(const void* rowdat, int n, void* pfx,
                                  void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    tiered_prefix_kernel<<<(1u << kPrefixBits) / kThreads + 1, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int4*)rowdat, n, (int32_t*)pfx);
    return (int)cudaGetLastError();
}

// pfx: the chunk's prefix table (kasa_tiered_prefix); num_steps must
// reach the bit length of n.
extern "C" int kasa_tiered_pass(const void* rowdat, const void* mstart,
                                const void* mrow, const void* moff,
                                const void* d_tax4, const void* weights,
                                const void* masks, const void* qr,
                                const void* vbr, const void* posr,
                                const void* pfx, long long lo, long long hi,
                                int n, int mp, int dr, int num_k,
                                int num_steps, int msteps, int full0,
                                int full1, int S, int kpr, int tmax,
                                void* skey, void* sflat, void* cflat,
                                void* big, void* stream) {
    if (n < 1 || mp < 1 || dr < 1 || num_k < 1 || num_k > 6 || kpr < 1
        || tmax > 30 || lo < 0 || hi < lo || pfx == nullptr)
        return (int)cudaErrorInvalidValue;
    // the fixed bisect for a window above every row: each step sets
    // lo = mid + 1 (hi stays n), and a step after lo reaches n gives n + 1
    int above = 0;
    for (int step = 0; step < num_steps; ++step)
        above = (int)(((long long)above + n) >> 1) + 1;
    PassParams p{lo, hi, n, mp, dr, num_k, msteps,
                 full0, full1, S, kpr, tmax, above};
    if (hi > lo) {
        const long long blocks = (hi - lo + kThreads - 1) / kThreads;
        tiered_pass_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
            (const int4*)rowdat, (const int32_t*)mstart,
            (const int32_t*)mrow, (const int32_t*)moff, (const int4*)d_tax4,
            (const float*)weights, (const int2*)masks, (const int2*)qr,
            (const int32_t*)vbr, (const int32_t*)posr,
            (const int32_t*)pfx, p, (int32_t*)skey,
            (float*)sflat, (float*)cflat, (int32_t*)big);
    }
    return (int)cudaGetLastError();
}
