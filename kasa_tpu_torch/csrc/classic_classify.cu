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
// Bound on the H100: the random gathers of a batch in read order.  A
// read's windows are unrelated keys, so each window's search and its
// per-level grp_id, grp_start and d_tax reads land on sectors spread
// over the index and the group tables (one table of numK per field);
// K10 runs the same search near its byte bound only because its windows
// come sorted by key.  On the default batch the local arm without any
// add keeps 1.13 of its 1.23 ms (PERF.md).  Before this design the adds
// cost most: a read drawn from species X hits a group holding X at
// nearly every window and level, and in read order neighbouring windows
// are neighbouring lanes, so one add instruction of a warp hit the same
// cell up to 32 times, and atomics to one address serialise.
//
// Two arms, picked by kernels.classic_arm from S, the layout and the
// card's opt-in shared memory (kasa_classic_smem_budget):
//   local   one block per read, where each read's windows form one run:
//           the uniform layout (read r is windows [r*kpr, (r+1)*kpr)),
//           or the scatter layout when its read ids ascend (the wrapper
//           checks them; a first pass, seg_kernel, writes where each
//           read's windows start).  The block's threads take the read's
//           windows, blockDim at a time.  Every add is combined first:
//           the lanes that hold the same taxon find each other
//           (__match_any_sync, or one vote when the whole warp holds one
//           taxon), sum their terms by shuffles and the lowest adds
//           once; no instruction adds twice to one address.  The read's
//           score row sits in shared memory in float64 (float32 adds of
//           one constant drift 9e-5 relative on a 24 k-window read,
//           against 2e-5 allowed) and is written once to the float32
//           output with coalesced stores, every row, zeros for a read
//           without windows: the output needs no fill and no rounding
//           pass.  The counts (numK x S) take the combined adds in
//           device memory: a per-block shared copy beside the row held
//           two blocks an SM at S = 2,047 and lost (PERF.md).
//   global  read ids that do not ascend (the per-batch engine under -e
//           hands windows in key order), or a row of S float64 cells
//           beyond the block's shared memory: one thread per window in
//           layout order, each lane adding its group's taxa itself, the
//           score cells by float64 atomics in a (R, S) buffer that the
//           wrapper rounds to float32 once.  counts_all and
//           counts_unique sit in a per-block shared copy over a
//           persistent grid, flushed once, where 8 * numK * S bytes fit
//           the block, else in device memory.  Combining lost here:
//           windows of other reads share no cells, and two
//           __match_any_sync a taxon cost 2.5x (PERF.md).
// Float sums are therefore taken in another order than kasa_tpu's and
// than the plain version's (the tests hold them to rtol 2e-5 / atol
// 1e-4); the integer outputs are exact.
#include "common.cuh"

namespace {

constexpr int kGlobalThreads = 1024;  // global arm (as many warps per SM
                                      // as its persistent grid allows)
constexpr int kLocalThreads = 512;    // most threads of a local block
constexpr int kMaxLevels = 25;
constexpr int kSmemReserve = 64;      // static shared memory of a block
constexpr unsigned kFull = 0xffffffffu;

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
    const long long* seg;      // (R + 1,) first window of each read
                               // (local arm, scatter layout) or null
    long long n, gmax, tmax, M;
    int num_k, min_k, max_k, S, cap, kpr, R;
    float* scores;             // (R, S) local arm
    double* scores64;          // (R, S) global arm, rounded by the wrapper
    float* counts_all;         // (numK, S)
    int32_t* counts_unique;    // (numK, S)
    int32_t* tail;             // (1,)
};

// ---------------------------------------------------------------------
// local arm

// The three terms one lane adds to one taxon of its read.
struct Terms {
    double w;    // w(k)/T to the score row
    float c;     // 1/T to counts_all
    int u;       // 1 to counts_unique (a one-taxon group)
};

// One add instruction of the warp, every lane calling: the lane's taxon
// tax (-1 for none) of level ki with its terms, combined per taxon
// before any add.  The common case, the whole warp on one taxon, takes
// one vote and a butterfly sum; else the lanes of each taxon find each
// other by __match_any_sync.
__device__ __forceinline__ void add_local(const Params& p, double* srow,
                                          int ki, int tax, Terms t) {
    const int top = __reduce_max_sync(kFull, tax);
    const unsigned lane = threadIdx.x & 31u;
    bool lead;
    if (__all_sync(kFull, tax < 0 || tax == top)) {
        if (top < 0) return;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            t.w += __shfl_xor_sync(kFull, t.w, off);
            t.c += __shfl_xor_sync(kFull, t.c, off);
        }
        t.u = __reduce_add_sync(kFull, t.u);
        tax = top;
        lead = lane == 0;
    } else {
        // the lanes holding each taxon sum their terms by a log-step tree
        // over their ranks, each adding the terms of the next peer still
        // in the tree, so that the lowest peer ends with the sum (a warp
        // of distinct taxa leaves at the first vote)
        const unsigned peers = __match_any_sync(kFull, tax);
        const unsigned below = peers & ((1u << lane) - 1u);
        unsigned rest = peers & (0xfffffffeu << lane);
        int rank = __popc(below);
        while (__any_sync(kFull, rest != 0u)) {
            const int next = __ffs(rest);
            const int src = next ? next - 1 : (int)lane;
            const double w = __shfl_sync(kFull, t.w, src);
            const float c = __shfl_sync(kFull, t.c, src);
            const int u = __shfl_sync(kFull, t.u, src);
            if (next) {
                t.w += w;
                t.c += c;
                t.u += u;
            }
            rest &= ~__ballot_sync(kFull, rank & 1);
            rank >>= 1;
        }
        lead = tax >= 0 && below == 0u;
    }
    if (lead) {
        const long long cell = (long long)ki * p.S + tax;
        atomicAdd(srow + tax, t.w);
        atomicAdd(p.counts_all + cell, t.c);
        if (t.u) atomicAdd(p.counts_unique + cell, t.u);
    }
}

// Window m of the lane (active: m is a window of the block's read in
// this step).  Every lane of the warp calls it: the level loop and the
// taxon loop run to the warp's largest group, so that the lanes meet at
// every add.
template <int L>
__device__ __forceinline__ void local_window(const Params& p, long long m,
                                             bool active, double* srow,
                                             int& tail) {
    int32_t q[L], at[L], pr[L];
    int kv = 0;
    long long pos = 0;
    if (active) active = p.q_valid[m] != 0;
    if (active) {
#pragma unroll
        for (int i = 0; i < L; ++i) q[i] = p.q[m * L + i];
        kv = valid_level<L>(q, p.min_k, p.max_k);
        active = kv >= p.min_k;
    }
    if (active) {
        pos = lower_bound_full<L>(p.idx, p.prefix, p.run_end, p.n, q);
#pragma unroll
        for (int i = 0; i < L; ++i) {
            at[i] = pos < p.n ? p.idx[pos * L + i] : 0;
            pr[i] = pos > 0 ? p.idx[(pos - 1) * L + i] : 0;
        }
    }
    for (int ki = 0; ki < p.num_k; ++ki) {
        int T = 0;
        const int32_t* taxa = p.d_tax;
        float w_over_t = 0.0f, inv_t = 0.0f;
        if (active && ki >= p.max_k - kv) {
            bool eq_at = pos < p.n, eq_pr = pos > 0;
#pragma unroll
            for (int i = 0; i < L; ++i) {
                const int32_t mk = p.masks[ki * L + i];
                const int32_t qm = q[i] & mk;
                eq_at = eq_at && ((at[i] & mk) == qm);
                eq_pr = eq_pr && ((pr[i] & mk) == qm);
            }
            if (eq_at || eq_pr) {
                const long long e = eq_at ? pos : pos - 1;
                const long long g = p.grp_id[ki * p.n + e];
                const int32_t* gs = p.grp_start + ki * p.gmax + g;
                const int ts = gs[0];
                T = gs[1] - ts;
                tail += max(T - p.cap, 0);
                w_over_t = p.weights[ki] / (float)T;
                inv_t = 1.0f / (float)T;
                taxa = p.d_tax + ki * p.tmax + ts;
            }
        }
        const int tw = __reduce_max_sync(kFull, T);
        for (int j0 = 0; j0 < tw; j0 += 4) {
            // four taxa loads in flight before the first add
            int tx[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) tx[u] = j0 + u < T ? taxa[j0 + u] : -1;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (j0 + u >= tw) break;
                const bool on = tx[u] >= 0;
                add_local(p, srow, ki, tx[u],
                          Terms{on ? (double)w_over_t : 0.0,
                                on ? inv_t : 0.0f, (on && T == 1) ? 1 : 0});
            }
        }
    }
}

template <int L>
__global__ void __launch_bounds__(kLocalThreads) local_kernel(Params p) {
    extern __shared__ double srow[];     // the block's read's row
    __shared__ int s_tail;
    for (int i = threadIdx.x; i < p.S; i += blockDim.x) srow[i] = 0.0;
    if (threadIdx.x == 0) s_tail = 0;
    __syncthreads();
    int tail = 0;
    for (long long r = blockIdx.x; r < p.R; r += gridDim.x) {
        long long s, e;
        if (p.kpr > 0) {
            s = min(r * p.kpr, p.M);
            e = min(s + p.kpr, p.M);
        } else {
            s = p.seg[r];
            e = p.seg[r + 1];
        }
        // whole warps step together: the bounds are the block's
        for (long long base = s; base < e; base += blockDim.x) {
            const long long m = base + threadIdx.x;
            local_window<L>(p, m, m < e, srow, tail);
        }
        __syncthreads();
        float* out = p.scores + r * p.S;
        for (int c = threadIdx.x; c < p.S; c += blockDim.x) {
            out[c] = (float)srow[c];
            srow[c] = 0.0;
        }
        __syncthreads();
    }
    for (int off = 16; off > 0; off >>= 1)
        tail += __shfl_down_sync(kFull, tail, off);
    if ((threadIdx.x & 31) == 0 && tail) atomicAdd(&s_tail, tail);
    __syncthreads();
    if (threadIdx.x == 0 && s_tail) atomicAdd(p.tail, s_tail);
}

// seg[r] = the first window whose read id is >= r, for r in [0, R], of
// read ids that ascend: thread m writes the reads r with
// read_ids[m-1] < r <= read_ids[m] (none below window 0, R above the
// last), so each r is written once.
__global__ void seg_kernel(const int32_t* read_ids, long long M, int R,
                           long long* seg) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m > M) return;
    const long long a = m == 0 ? -1 : (long long)read_ids[m - 1];
    const long long b = m == M ? R : min((long long)read_ids[m], (long long)R);
    for (long long r = max(a + 1, 0LL); r <= b; ++r) seg[r] = m;
}

template <int L>
int launch_local(const Params& p, int sms, cudaStream_t stream) {
    if (p.kpr == 0) {
        seg_kernel<<<(unsigned)((p.M + 256) / 256), 256, 0, stream>>>(
            p.read_ids, p.M, p.R, const_cast<long long*>(p.seg));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    // a block as wide as a read's windows, in whole warps
    const long long per_read = p.kpr > 0 ? p.kpr : (p.M + p.R - 1) / p.R;
    const int threads = (int)min(max((per_read + 31) / 32 * 32, 64LL),
                                 (long long)kLocalThreads);
    const size_t smem = (size_t)8 * p.S;
    cudaError_t err = cudaFuncSetAttribute(
        local_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, local_kernel<L>, threads, smem);
    if (err != cudaSuccess) return (int)err;
    // a persistent grid: each block zeroes its row once
    const long long blocks = max(min((long long)p.R,
                                     (long long)max(per_sm, 1) * sms), 1LL);
    local_kernel<L><<<(unsigned)blocks, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// global arm

template <int L>
__global__ void __launch_bounds__(kGlobalThreads)
global_kernel(Params p, int shared_counts) {
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
        double* srow = p.scores64 + row * p.S;
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
int launch_global(const Params& p, int sms, cudaStream_t stream) {
    const size_t cbytes = (size_t)8 * p.num_k * p.S;
    int dev_max = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&dev_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const int shared_counts = cbytes + kSmemReserve <= (size_t)dev_max;
    const size_t smem = shared_counts ? cbytes : 0;
    long long blocks = (p.M + kGlobalThreads - 1) / kGlobalThreads;
    if (shared_counts) {
        cudaError_t err = cudaFuncSetAttribute(
            global_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, global_kernel<L>, kGlobalThreads, smem);
        // a persistent grid: each block flushes its counts once
        blocks = min(blocks, (long long)max(per_sm, 1) * sms);
    } else {
        blocks = min(blocks, (long long)sms * 64);
    }
    blocks = max(blocks, 1LL);
    global_kernel<L><<<(unsigned)blocks, kGlobalThreads, smem, stream>>>(
        p, shared_counts);
    return (int)cudaGetLastError();
}


template <int L>
int launch(const Params& p, int local, int sms, cudaStream_t stream) {
    return local ? launch_local<L>(p, sms, stream)
                 : launch_global<L>(p, sms, stream);
}

}  // namespace

// Shared memory a block of K9 may fill on `device` (the opt-in maximum
// less the kernels' static part): the local arm's row needs 8 * S bytes,
// the global arm's shared counts 8 * numK * S.  Negative: a CUDA error.
extern "C" int kasa_classic_smem_budget(int device) {
    int optin = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return -(int)err;
    return optin - kSmemReserve;
}

// local: 1 for the local arm (scores (R, S) float32, written whole;
// seg: (R + 1,) int64 scratch in the scatter layout, whose read ids must
// ascend), 0 for the global arm (scores (R, S) float64, zeroed).
extern "C" int kasa_classic_classify(
        const void* idx, const void* grp_id, const void* grp_start,
        const void* d_tax, const void* masks, const void* weights,
        const void* run_end, const void* prefix, const void* q,
        const void* read_ids, const void* q_valid, long long n,
        long long gmax, long long tmax, long long M, int L, int num_k,
        int min_k, int max_k, int S, int cap, int kpr, int R, int local,
        int sms, void* seg, void* scores, void* counts_all,
        void* counts_unique, void* tail, void* stream) {
    if (L < 2 || L > 5 || num_k < 1 || num_k > kMaxLevels
            || max_k - min_k + 1 != num_k || min_k < 1 || S < 1 || R < 0
            || (kpr == 0 && read_ids == nullptr)
            || (local && kpr == 0 && seg == nullptr))
        return (int)cudaErrorInvalidValue;
    if (M <= 0 || n <= 0 || R == 0) return (int)cudaGetLastError();
    Params p{(const int32_t*)idx, (const int32_t*)grp_id,
             (const int32_t*)grp_start, (const int32_t*)d_tax,
             (const int32_t*)masks, (const float*)weights,
             (const int32_t*)run_end, (const int32_t*)prefix,
             (const int32_t*)q, (const int32_t*)read_ids,
             (const uint8_t*)q_valid, (const long long*)seg, n, gmax, tmax,
             M, num_k, min_k, max_k, S, cap, kpr, R,
             local ? (float*)scores : nullptr,
             local ? nullptr : (double*)scores, (float*)counts_all,
             (int32_t*)counts_unique, (int32_t*)tail};
    cudaStream_t s = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch<2>(p, local, sms, s);
        case 3: return launch<3>(p, local, sms, s);
        case 4: return launch<4>(p, local, sms, s);
        default: return launch<5>(p, local, sms, s);
    }
}
