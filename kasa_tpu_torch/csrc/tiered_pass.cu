// K8 tiered_pass: one index chunk searched by the windows routed to it.
//
// Replaces kasa_tpu/match/tiered.py:201 tiered_chunk_pass.  kasa_tpu
// runs it in fixed passes of PASS_CAP windows only to keep its compiled
// shapes fixed; here one launch takes all of a chunk's routed windows,
// one thread per window, with kasa_tpu's arithmetic and clamps:
//   - the fixed num_steps bisect over the chunk's padded rowdat
//     ((pad, 4) int32 [l0, l1, tax, tpack], pad rows INT32_MAX) with
//     min(mid, n-1) (234-240), then the rows at pos and pos-1 (both
//     gathered clamped to n-1);
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
// A lane expands its own group's rows only.  (kasa_tpu's while loop runs
// every lane of a pass until the largest T of the pass is done, so a
// lane with a smaller group also adds the taxa of the rows after its
// own, which belong to the next multi groups; the port does not repeat
// that: ROADMAP.md, Queue 3.)  The float sums differ from kasa_tpu's by
// the order of the atomics only.
//
// Bound on the H100: dependent random gathers.  Per window num_steps
// rowdat rows of 16 bytes (the chunk, 134 MB at 8.4 M entries, does not
// stay in the 50 MB L2), two more rows, and for a multi hit msteps
// mstart entries, a mrow entry and up to 8 taxa rows; the expansion's
// atomics land on the batch's (R, S) rows.  The least bytes are the
// distinct 32-byte sectors these gathers touch plus the routed windows
// and the slot row written once.
#include "common.cuh"

namespace {

struct PassParams {
    long long lo, hi;
    int n, mp, dr, num_k, num_steps, msteps, full0, full1, S, kpr, tmax;
};

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

    int lo = 0, hi = p.n;
    for (int step = 0; step < p.num_steps; ++step) {
        const int mid = (int)(((long long)lo + hi) >> 1);
        const int4 kk = __ldg(&rowdat[min(mid, p.n - 1)]);
        const bool less = kk.x < q.x || (kk.x == q.x && kk.y < q.y);
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    const int pos = lo;
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

extern "C" int kasa_tiered_pass(const void* rowdat, const void* mstart,
                                const void* mrow, const void* moff,
                                const void* d_tax4, const void* weights,
                                const void* masks, const void* qr,
                                const void* vbr, const void* posr,
                                long long lo, long long hi,
                                int n, int mp, int dr, int num_k,
                                int num_steps, int msteps, int full0,
                                int full1, int S, int kpr, int tmax,
                                void* skey, void* sflat, void* cflat,
                                void* big, void* stream) {
    if (n < 1 || mp < 1 || dr < 1 || num_k < 1 || num_k > 6 || kpr < 1
        || tmax > 30 || lo < 0 || hi < lo)
        return (int)cudaErrorInvalidValue;
    PassParams p{lo, hi, n, mp, dr, num_k, num_steps, msteps,
                 full0, full1, S, kpr, tmax};
    if (hi > lo) {
        const int threads = 256;
        const long long blocks = (hi - lo + threads - 1) / threads;
        tiered_pass_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            (const int4*)rowdat, (const int32_t*)mstart,
            (const int32_t*)mrow, (const int32_t*)moff, (const int4*)d_tax4,
            (const float*)weights, (const int2*)masks, (const int2*)qr,
            (const int32_t*)vbr, (const int32_t*)posr, p, (int32_t*)skey,
            (float*)sflat, (float*)cflat, (int32_t*)big);
    }
    return (int)cudaGetLastError();
}
