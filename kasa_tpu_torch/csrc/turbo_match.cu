// K2 turbo_match: per window, the full-key lower_bound in the index and
// the per-level slots.
//
// Replaces the "search" and "slots" stages of kasa_tpu/match/turbo.py
// :518 _turbo_core (lines 569-667): '^' validity per k level; the
// 24-bit router row, the sub-router row of a fat bucket and num_steps
// bisect steps over keys2; then the index rows at pos and pos-1 and,
// per k level, a masked prefix compare that yields either a T == 1
// slot key tax*8+ki or a multi-taxa payload psel*8+ki.
//
// Bound on the H100: dependent random gathers.  Per window: one 8-byte
// router row, maybe one sub-router row, num_steps 8-byte keys2 rows and
// two 16-byte rowdat rows, each on its own 32-byte sector; the tables
// (hundreds of MB at full size) do not fit the 50 MB L2, so most
// gathers go to device memory, and each step waits for the previous.
// The last steps of a bisect over a bucket of ~8 keys re-read sectors
// the first ones loaded, so the bytes the search needs are the
// distinct sectors it touches, a few per window.
//
// Design: one thread per window (enough windows in flight to hide the
// latency of the chain), the whole chain in registers, read-only
// loads; outputs are written slot-major per read, (R, SW) with slot
// window*numK + ki, as kasa_tpu lays them out.  The search reproduces
// kasa_tpu exactly, including its fixed step count (a window above
// every key ends at pos = n + 1) and its clamped gathers.
#include "common.cuh"

namespace {

struct MatchParams {
    int n, num_k, min_k, max_k, num_steps, sent;
    long long M;
};

__global__ void turbo_match_kernel(const int2* __restrict__ q,
                                   const int2* __restrict__ router,
                                   const int2* __restrict__ sub2,
                                   const int2* __restrict__ keys2,
                                   const int4* __restrict__ rowdat,
                                   const int2* __restrict__ masks2,
                                   MatchParams p,
                                   int32_t* __restrict__ skey,
                                   int32_t* __restrict__ mpay) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= p.M) return;
    const int2 qq = __ldg(&q[m]);
    const int q0 = qq.x, q1 = qq.y;

    // cumulative '^' (code 30) validity over letters min_k-1 .. k-1
    unsigned ok_bits = 0;   // bit ki set: valid at k = max_k - ki
    {
        bool ok = true;
        for (int pos = p.min_k - 1; pos < p.max_k; ++pos) {
            const int limb = pos < 6 ? q0 : q1;
            const int shift = 5 * (5 - (pos % 6));
            ok = ok && (((limb >> shift) & 31) != 30);
            const int ki = p.max_k - (pos + 1);
            if (ok) ok_bits |= 1u << ki;
        }
    }

    // router (+ sub-router) bounds
    const int2 rr = __ldg(&router[q0 >> 6]);
    int lo = rr.x, hi = rr.y;
    if (rr.y < 0) {
        const int code = -rr.y;
        const int sub_base = code >> 5;
        const int s = code & 31;
        const int subkey = ((q0 & 0x3F) << 18) | (q1 >> 12);
        const int2 srow = __ldg(&sub2[sub_base + (subkey >> (24 - s))]);
        lo = srow.x;
        hi = srow.y;
    }
    for (int step = 0; step < p.num_steps; ++step) {
        const int mid = (lo + hi) >> 1;
        const int2 kk = __ldg(&keys2[min(mid, p.n - 1)]);
        const bool less = (kk.x < q0) || (kk.x == q0 && kk.y < q1);
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    const int pos = lo;
    const int pos_c = min(pos, p.n - 1);
    const bool at_n = pos >= p.n;
    const int prev = max(pos - 1, 0);
    const int4 at = __ldg(&rowdat[pos_c]);
    const int4 pv = __ldg(&rowdat[min(prev, p.n - 1)]);
    const bool prev_ok = pos > 0;

    const long long base = m * p.num_k;
    for (int ki = 0; ki < p.num_k; ++ki) {
        const int2 mk = __ldg(&masks2[ki]);
        const int qm0 = q0 & mk.x, qm1 = q1 & mk.y;
        const bool hit_at = !at_n && ((at.x & mk.x) == qm0)
                            && ((at.y & mk.y) == qm1);
        const bool hit_pv = prev_ok && ((pv.x & mk.x) == qm0)
                            && ((pv.y & mk.y) == qm1);
        const bool matched = (hit_at || hit_pv) && ((ok_bits >> ki) & 1u);
        const int tax = hit_pv ? pv.z : at.z;
        const int tp = hit_pv ? pv.w : at.w;
        const int tc = (tp >> (5 * ki)) & 31;
        const int psel = hit_pv ? prev : pos_c;
        skey[base + ki] = (matched && tc == 1) ? tax * 8 + ki : p.sent;
        mpay[base + ki] = (matched && tc >= 2) ? psel * 8 + ki : -1;
    }
}

}  // namespace

extern "C" int kasa_turbo_match(const void* q, const void* router,
                                const void* sub2, const void* keys2,
                                const void* rowdat, const void* masks2,
                                long long M, int n, int num_k, int min_k,
                                int max_k, int num_steps, int sent,
                                void* skey, void* mpay, void* stream) {
    MatchParams p{n, num_k, min_k, max_k, num_steps, sent, M};
    if (M > 0) {
        const int threads = 256;
        const long long blocks = (M + threads - 1) / threads;
        turbo_match_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            (const int2*)q, (const int2*)router, (const int2*)sub2,
            (const int2*)keys2, (const int4*)rowdat, (const int2*)masks2, p,
            (int32_t*)skey, (int32_t*)mpay);
    }
    return (int)cudaGetLastError();
}
