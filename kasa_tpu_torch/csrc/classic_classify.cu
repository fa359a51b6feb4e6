// K9 classic_classify: the classic engine's batch classify.
//
// Replaces kasa_tpu/match/device.py:156 classify_batch (reached from
// match/fast.py:138 fused_classify and from match/engine.py:TpuEngine):
// for every valid query window and every k level in [min_k, max_k]
// (row ki <-> k = max_k - ki) the query's k-prefix group in the sorted
// index, T = its distinct taxa; each taxon gets w(k)/T in the read's
// score row and 1/T in counts_all[ki], a one-taxon group 1 in
// counts_unique[ki].  A query is valid at k while none of its letters at
// positions min_k-1 .. k-1 is '^' (30).  Every taxon of every group is
// added (kasa_tpu's base tile + tail loop, device.py:434-460); tail_pairs
// = sum of max(T - cap, 0) over the matched (query, level) pairs.
//
// kasa_tpu computes this with one of three lowerings (run-scan, dense,
// scatter) and, for 128-bit indices and k < 6, a full masked search per
// level.  K9 computes the function once: ONE lower bound of the full key
// per query decides every level, because k-prefix groups nest inside the
// sorted order (the level-k group [a, b) of q holds lower_bound(q) in
// [a, b], so a non-empty group shows q's prefix at pos or pos - 1, an
// empty one at neither).  The lower bound: common.cuh lower_bound_full
// (prefix bucket, limb-0 bisect, then limbs 1..L-1 inside the limb-0
// run, both bisects to convergence).
//
// Bound on the H100: memory latency, not bytes.  The function's own
// bytes are the queries, the rows and group entries it touches and the
// outputs (chip_smoke.py counts them); each query walks ~log2(bucket) +
// log2(run) dependent gathers, then per level one grp_id, two grp_start
// and T d_tax reads.  The design keeps many queries in flight: one
// thread per query, grid-stride, blocks of 1,024 threads (so the
// persistent grid of the shared-count mode below still holds 32 warps
// per SM), the index rows in L1/L2 where queries share buckets.
//
// Accumulation: scores (R, S) by atomicAdd on float64 cells in device
// memory (a read's windows hit the same cells; the adds serialise per
// cell); the wrapper rounds them to float32 once.  A read of 24 k windows
// adds the same w(k)/T thousands of times to one cell, and float32 adds
// of a constant drift one way: 9e-5 relative on such a read, measured on
// the card, against 2e-5 allowed.
// counts_all and counts_unique (numK x S) are hit by every block, so when
// 8 * numK * S bytes fit the block's shared memory each block adds into
// its own copy and flushes the non-zero cells once with atomics at the
// end (a persistent grid of a few blocks per SM); otherwise they go
// straight to device memory.  Float sums are therefore taken in another
// order than kasa_tpu's and than the plain version's (the tests hold them
// to rtol 2e-5 / atol 1e-4); the integer outputs are exact.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLevels = 25;

struct Params {
    const int32_t* idx;        // (n, L)
    const int32_t* grp_id;     // (numK, n)
    const int32_t* grp_start;  // (numK, gmax)
    const int32_t* d_tax;      // (numK, tmax)
    const int32_t* masks;      // (numK, L)
    const float* weights;      // (numK,)
    const int32_t* run_end;    // (n,)
    const int32_t* prefix;     // (2^20 + 1,)
    const int32_t* q;          // (M, L)
    const int32_t* read_ids;   // (M,) or null (uniform layout)
    const uint8_t* q_valid;    // (M,)
    long long n, gmax, tmax, M;
    int num_k, min_k, max_k, S, cap, kpr;
    double* scores;            // (R, S), rounded to float32 by the wrapper
    float* counts_all;         // (numK, S)
    int32_t* counts_unique;    // (numK, S)
    int32_t* tail;             // (1,)
};

template <int L>
__global__ void __launch_bounds__(kThreads)
classic_kernel(Params p, int shared_counts) {
    extern __shared__ unsigned char smem[];
    float* s_ca = reinterpret_cast<float*>(smem);
    int32_t* s_cu = reinterpret_cast<int32_t*>(
        smem + sizeof(float) * p.num_k * p.S);
    __shared__ int s_tail;
    const int cells = p.num_k * p.S;
    if (shared_counts) {
        for (int i = threadIdx.x; i < cells; i += blockDim.x) {
            s_ca[i] = 0.0f;
            s_cu[i] = 0;
        }
    }
    if (threadIdx.x == 0) s_tail = 0;
    __syncthreads();
    float* ca = shared_counts ? s_ca : p.counts_all;
    int32_t* cu = shared_counts ? s_cu : p.counts_unique;
    int tail = 0;

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         m < p.M; m += stride) {
        if (!p.q_valid[m]) continue;
        int32_t q[L];
#pragma unroll
        for (int i = 0; i < L; ++i) q[i] = p.q[m * L + i];
        const int kv = valid_level<L>(q, p.min_k, p.max_k);
        if (kv < p.min_k) continue;
        const long long pos = lower_bound_full<L>(p.idx, p.prefix,
                                                  p.run_end, p.n, q);
        int32_t at[L], pr[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
            at[i] = pos < p.n ? p.idx[pos * L + i] : 0;
            pr[i] = pos > 0 ? p.idx[(pos - 1) * L + i] : 0;
        }
        const long long row = p.kpr > 0 ? m / p.kpr : p.read_ids[m];
        double* srow = p.scores + row * p.S;
        for (int ki = max(p.max_k - kv, 0); ki < p.num_k; ++ki) {
            bool eq_at = pos < p.n, eq_pr = pos > 0;
#pragma unroll
            for (int i = 0; i < L; ++i) {
                const int32_t mk = p.masks[ki * L + i];
                const int32_t qm = q[i] & mk;
                eq_at = eq_at && ((at[i] & mk) == qm);
                eq_pr = eq_pr && ((pr[i] & mk) == qm);
            }
            if (!eq_at && !eq_pr) continue;
            const long long e = eq_at ? pos : pos - 1;
            const long long g = p.grp_id[ki * p.n + e];
            const int32_t* gs = p.grp_start + ki * p.gmax + g;
            const int ts = gs[0];
            const int T = gs[1] - ts;
            tail += max(T - p.cap, 0);
            const float w_over_t = p.weights[ki] / (float)T;
            const float inv_t = 1.0f / (float)T;
            const int32_t* taxa = p.d_tax + ki * p.tmax + ts;
            for (int j = 0; j < T; ++j) {
                const int tax = taxa[j];
                atomicAdd(srow + tax, (double)w_over_t);
                atomicAdd(ca + ki * p.S + tax, inv_t);
            }
            if (T == 1) atomicAdd(cu + ki * p.S + taxa[0], 1);
        }
    }
    // tail_pairs: warp sums, then one add per warp and one per block
    for (int off = 16; off > 0; off >>= 1)
        tail += __shfl_down_sync(0xffffffffu, tail, off);
    if ((threadIdx.x & 31) == 0 && tail) atomicAdd(&s_tail, tail);
    __syncthreads();
    if (threadIdx.x == 0 && s_tail) atomicAdd(p.tail, s_tail);
    if (shared_counts) {
        for (int i = threadIdx.x; i < cells; i += blockDim.x) {
            if (s_ca[i] != 0.0f) atomicAdd(p.counts_all + i, s_ca[i]);
            if (s_cu[i] != 0) atomicAdd(p.counts_unique + i, s_cu[i]);
        }
    }
}

template <int L>
int launch(const Params& p, int sms, cudaStream_t stream) {
    const size_t cbytes = (size_t)8 * p.num_k * p.S;
    int dev_max = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&dev_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const int shared_counts = cbytes + 64 <= (size_t)dev_max;
    const size_t smem = shared_counts ? cbytes : 0;
    long long blocks = (p.M + kThreads - 1) / kThreads;
    if (shared_counts) {
        cudaError_t err = cudaFuncSetAttribute(
            classic_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, classic_kernel<L>, kThreads, smem);
        // a persistent grid: each block flushes its counts once
        blocks = min(blocks, (long long)max(per_sm, 1) * sms);
    } else {
        blocks = min(blocks, (long long)sms * 64);
    }
    blocks = max(blocks, 1LL);
    classic_kernel<L><<<(unsigned)blocks, kThreads, smem, stream>>>(
        p, shared_counts);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kasa_classic_classify(
        const void* idx, const void* grp_id, const void* grp_start,
        const void* d_tax, const void* masks, const void* weights,
        const void* run_end, const void* prefix, const void* q,
        const void* read_ids, const void* q_valid, long long n,
        long long gmax, long long tmax, long long M, int L, int num_k,
        int min_k, int max_k, int S, int cap, int kpr, int sms,
        void* scores, void* counts_all, void* counts_unique, void* tail,
        void* stream) {
    if (L < 2 || L > 5 || num_k < 1 || num_k > kMaxLevels
            || max_k - min_k + 1 != num_k || min_k < 1 || S < 1)
        return (int)cudaErrorInvalidValue;
    if (M <= 0 || n <= 0) return (int)cudaGetLastError();
    Params p{(const int32_t*)idx, (const int32_t*)grp_id,
             (const int32_t*)grp_start, (const int32_t*)d_tax,
             (const int32_t*)masks, (const float*)weights,
             (const int32_t*)run_end, (const int32_t*)prefix,
             (const int32_t*)q, (const int32_t*)read_ids,
             (const uint8_t*)q_valid, n, gmax, tmax, M, num_k, min_k,
             max_k, S, cap, kpr, (double*)scores, (float*)counts_all,
             (int32_t*)counts_unique, (int32_t*)tail};
    cudaStream_t s = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch<2>(p, sms, s);
        case 3: return launch<3>(p, sms, s);
        case 4: return launch<4>(p, sms, s);
        default: return launch<5>(p, sms, s);
    }
}
