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
// Bound on the H100: dependent random gathers.  Per window: one 8-byte
// router row, maybe one sub-router row, num_steps keys2 rows of 4*L
// bytes and two rowdat rows of 4*(L+2) bytes, each within one or two
// 32-byte sectors; the tables (hundreds of MB to GB at full size) do not
// fit the 50 MB L2, so most gathers go to device memory, and each step
// waits for the previous.  The last steps of a bisect over a bucket of
// ~8 keys re-read sectors the first ones loaded, so the bytes the search
// needs are the distinct sectors it touches, a few per window.
//
// Design: one thread per window (enough windows in flight to hide the
// latency of the chain), the whole chain in registers (the limb count is
// a template parameter, so the limb arrays stay in registers), read-only
// loads; outputs are written slot-major per read, (R, SW) with slot
// window*numK + ki, as kasa_tpu lays them out.  The router and the
// sub-router read limbs 0 and 1 only, as in kasa_tpu.  The search
// reproduces kasa_tpu exactly, including its fixed step count (a window
// above every key ends at pos = n + 1) and its clamped gathers.
#include "common.cuh"

namespace {

struct MatchParams {
    int n, num_k, min_k, max_k, num_steps, sent;
    long long M;
};

template <int L>
__global__ void turbo_match_kernel(const int32_t* __restrict__ q,
                                   const int2* __restrict__ router,
                                   const int2* __restrict__ sub2,
                                   const int32_t* __restrict__ keys2,
                                   const int32_t* __restrict__ rowdat,
                                   const int32_t* __restrict__ masks2,
                                   MatchParams p,
                                   int32_t* __restrict__ skey,
                                   int32_t* __restrict__ mpay) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= p.M) return;
    int qv[L];
#pragma unroll
    for (int i = 0; i < L; ++i) qv[i] = __ldg(&q[m * L + i]);
    const int q0 = qv[0], q1 = qv[1];

    // cumulative '^' (code 30) validity over letters min_k-1 .. k-1; the
    // letter at position pos sits in limb pos / 6
    unsigned ok_bits = 0;   // bit ki set: valid at k = max_k - ki
    {
        bool ok = true;
        for (int pos = p.min_k - 1; pos < p.max_k; ++pos) {
            int limb = qv[0];
#pragma unroll
            for (int i = 1; i < L; ++i) limb = (pos / 6 == i) ? qv[i] : limb;
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
        const int32_t* kk = keys2 + (long long)min(mid, p.n - 1) * L;
        // rows < q, lexicographic over the limbs (kasa_tpu's lex_less)
        bool less = __ldg(&kk[L - 1]) < qv[L - 1];
#pragma unroll
        for (int i = L - 2; i >= 0; --i) {
            const int k = __ldg(&kk[i]);
            less = (k < qv[i]) || (k == qv[i] && less);
        }
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    const int pos = lo;
    const int pos_c = min(pos, p.n - 1);
    const bool at_n = pos >= p.n;
    const int prev = max(pos - 1, 0);
    int at[L + 2], pv[L + 2];
    const int32_t* ra = rowdat + (long long)pos_c * (L + 2);
    const int32_t* rp = rowdat + (long long)min(prev, p.n - 1) * (L + 2);
#pragma unroll
    for (int i = 0; i < L + 2; ++i) {
        at[i] = __ldg(&ra[i]);
        pv[i] = __ldg(&rp[i]);
    }
    const bool prev_ok = pos > 0;

    const long long base = m * p.num_k;
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
        skey[base + ki] = (matched && tc == 1) ? tax * 8 + ki : p.sent;
        mpay[base + ki] = (matched && tc >= 2) ? psel * 8 + ki : -1;
    }
}

template <int L>
void launch(const void* q, const void* router, const void* sub2,
            const void* keys2, const void* rowdat, const void* masks2,
            MatchParams p, void* skey, void* mpay, cudaStream_t st) {
    const int threads = 256;
    const long long blocks = (p.M + threads - 1) / threads;
    turbo_match_kernel<L><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)q, (const int2*)router, (const int2*)sub2,
        (const int32_t*)keys2, (const int32_t*)rowdat,
        (const int32_t*)masks2, p, (int32_t*)skey, (int32_t*)mpay);
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
    if (M <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (L) {
        case 2: launch<2>(q, router, sub2, keys2, rowdat, masks2, p, skey,
                          mpay, st); break;
        case 3: launch<3>(q, router, sub2, keys2, rowdat, masks2, p, skey,
                          mpay, st); break;
        case 4: launch<4>(q, router, sub2, keys2, rowdat, masks2, p, skey,
                          mpay, st); break;
        case 5: launch<5>(q, router, sub2, keys2, rowdat, masks2, p, skey,
                          mpay, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
