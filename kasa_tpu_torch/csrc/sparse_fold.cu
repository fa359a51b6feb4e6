// K6 sparse_fold: the per-read multi-taxa lists of an index with more
// than SPARSE_FOLD_S species and no hot tier.
//
// Replaces the sparse branch of "bands" in kasa_tpu/match/turbo.py:518
// _turbo_core (870-920): every admitted cold slot of an unflagged read
// expands into one lane per taxon of its group, worth w(k)/T; kasa_tpu
// sorts all (read, tax, value) lanes of the batch by (read, tax), sums
// each run and scatters the first WM runs of each read, in taxon order,
// into an (R, WM+1) list whose last column marks a read with more than
// WM distinct multi taxa (multi_of).  The counts half of that branch
// (871-880) is K4's counts-only arm.
//
// No global sort here.  K4's worklist is read-major and every cold slot
// of an unflagged read was admitted (a dropped slot flags its read,
// turbo.py:761-766; a worklist overflow flags every read with a multi
// slot), so read r's lanes are exactly those of its own compacted
// payloads cp[r, :mcnt[r]].  One block per read walks them and keeps a
// bounded running list of the WM+1 smallest distinct taxa with their
// sums: each chunk of lanes is sorted in shared memory together with the
// list (common.cuh's bitonic sort), its runs are summed, and the list is
// cut back to WM+1.  This is exact: a taxon cut earlier had WM+1 smaller
// taxa at that moment, which stay in the list, so it cannot be among the
// first WM+1 at the end; a taxon that survives has the sum of all its
// lanes.  multi_of is "the list holds WM+1 taxa at the end", and the
// first WM entries are kasa_tpu's mk2/mv2 (turbo.py:914-918), multi_of
// reads included.
//
// Bound on the H100: the gathers of the expansion (each cold slot's grp2
// entry, its d_tax4 header and ceil(T/4) taxa rows, a few MB per batch)
// and the shared-memory sorts, O(C log^2 C) per chunk of C lanes; a read
// has 0 to ~10^5 lanes, so one read is never sorted whole and the work
// per block stays bounded by its own lanes.
//
// Design: one block of 256 threads per read.  Dynamic shared memory:
// a chunk of kChunk 64-bit keys (tax << 32 | position) and their values,
// then the read's slot table (lane prefix, group row, value; 12 bytes a
// slot, SW slots; for SW above 4096, long read lines, the table lives in
// a global scratch row of 3 SW + 1 int32 per read instead).  A lane finds its slot by a binary search of the lane
// prefix.  Within a run the sum is taken serially in sorted order (the
// list's partial sum first, then lanes in slot order): deterministic, in
// another order than kasa_tpu's scatter-add, so floats agree within the
// contract and integers are identical.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;
constexpr int kListMax = 256;

struct FoldParams {
    int SW, n, num_k, wm, sent;
};

__global__ void sparse_fold_kernel(const int32_t* __restrict__ cp,
                                   const int32_t* __restrict__ mcnt,
                                   const uint8_t* __restrict__ ofc,
                                   const int32_t* __restrict__ grp2,
                                   const int32_t* __restrict__ d_tax4,
                                   const float* __restrict__ weights,
                                   FoldParams p,
                                   int32_t* __restrict__ tab,
                                   int32_t* __restrict__ mk,
                                   float* __restrict__ mv,
                                   uint8_t* __restrict__ multi_of) {
    extern __shared__ unsigned long long keys[];        // kChunk
    float* vals = (float*)(keys + kChunk);              // kChunk
    __shared__ int32_t lt[kListMax], nt[kListMax];
    __shared__ float lv[kListMax], nv[kListMax];
    __shared__ long long scan_buf[kThreads];
    __shared__ int warp_sums[kWarps];
    const int tid = threadIdx.x;
    const long long r = blockIdx.x;
    int32_t* pre = tab ? tab + r * (3LL * p.SW + 1)     // SW + 1
                       : (int32_t*)(vals + kChunk);
    int32_t* srow = pre + p.SW + 1;                     // SW
    float* sval = (float*)(srow + p.SW);                // SW
    const int w1 = p.wm + 1;
    const int cnt = ofc[r] ? 0 : mcnt[r];
    const long long gmax = (long long)p.num_k * p.n - 1;

    // the read's cold slots: group row, lanes (= T), value w(k)/T
    for (int i = tid; i < cnt; i += kThreads) {
        const int32_t mp = cp[r * p.SW + i];
        const int ki = mp & 7;
        const int32_t row0 = grp2[min((long long)ki * p.n + (mp >> 3), gmax)];
        int T = 0;
        float val = 0.0f;
        if (row0 > 0) {                      // hot (< 0) sets do not exist
            T = d_tax4[(long long)row0 * 4];  // header row [T, ...]
            val = weights[ki] * (1.0f / (float)T);
        }
        pre[i] = T;
        srow[i] = row0;
        sval[i] = val;
    }
    __syncthreads();
    const int per = (cnt + kThreads - 1) / kThreads;
    const int i0 = min(tid * per, cnt), i1 = min(i0 + per, cnt);
    long long local = 0;
    for (int i = i0; i < i1; ++i) local += pre[i];
    long long lanes;
    long long run = block_exclusive_scan<kThreads>(local, scan_buf, &lanes);
    for (int i = i0; i < i1; ++i) {
        const int t = pre[i];
        pre[i] = (int32_t)run;
        run += t;
    }
    __syncthreads();

    // fold the lanes chunk by chunk into the list of the w1 smallest taxa
    int list_n = 0;
    const int cap = kChunk - w1;
    for (long long b0 = 0; b0 < lanes; b0 += cap) {
        const int used = list_n + (int)min((long long)cap, lanes - b0);
        int P = 32;
        while (P < used) P <<= 1;
        for (int i = tid; i < P; i += kThreads) {
            unsigned long long key = ~0ULL;
            if (i < list_n) {
                key = ((unsigned long long)(uint32_t)lt[i] << 32) | i;
                vals[i] = lv[i];
            } else if (i < used) {
                const int g = (int)(b0 + (i - list_n));
                int lo = 0, hi = cnt;        // the last slot with pre <= g
                while (hi - lo > 1) {
                    const int mid = (lo + hi) >> 1;
                    if (pre[mid] <= g) lo = mid; else hi = mid;
                }
                const int32_t tax = d_tax4[((long long)srow[lo] + 1) * 4
                                           + (g - pre[lo])];
                key = ((unsigned long long)(uint32_t)tax << 32) | i;
                vals[i] = sval[lo];
            }
            keys[i] = key;
        }
        __syncthreads();
        block_bitonic_sort<unsigned long long, kThreads>(keys, P);
        // run starts in taxon order; each of the first w1 sums its run
        int off = 0;
        for (int t0 = 0; t0 < used; t0 += kThreads) {
            const int i = t0 + tid;
            uint32_t tax = 0;
            bool start = false;
            if (i < used) {
                tax = (uint32_t)(keys[i] >> 32);
                start = i == 0
                        || (uint32_t)(keys[max(i - 1, 0)] >> 32) != tax;
            }
            int tot;
            const int rank = block_rank<kWarps>(start, warp_sums, &tot);
            if (start && off + rank < w1) {
                float sum = 0.0f;
                for (int j = i; j < used && (uint32_t)(keys[j] >> 32) == tax;
                     ++j)
                    sum += vals[(uint32_t)keys[j]];
                nt[off + rank] = (int32_t)tax;
                nv[off + rank] = sum;
            }
            off += tot;
        }
        __syncthreads();
        list_n = min(off, w1);
        for (int i = tid; i < list_n; i += kThreads) {
            lt[i] = nt[i];
            lv[i] = nv[i];
        }
        __syncthreads();
    }

    for (int j = tid; j < p.wm; j += kThreads) {
        const bool v = j < list_n;
        mk[r * p.wm + j] = v ? lt[j] : p.sent;
        mv[r * p.wm + j] = v ? lv[j] : 0.0f;
    }
    if (tid == 0) multi_of[r] = list_n == w1;
}

}  // namespace

extern "C" int kasa_sparse_fold(const void* cp, const void* mcnt,
                                const void* ofc, const void* grp2,
                                const void* d_tax4, const void* weights,
                                int R, int SW, int n, int num_k, int wm,
                                int sent, void* tab, void* mk, void* mv,
                                void* multi_of, void* stream) {
    // tab: null (the slot table in shared memory) or (R, 3 SW + 1) int32
    if (wm + 1 > kListMax || wm < 1 || SW < 1)
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)kChunk * (sizeof(unsigned long long)
                                          + sizeof(float))
                        + (tab ? 0 : (size_t)(3 * SW + 1) * sizeof(int32_t));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sparse_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    FoldParams p{SW, n, num_k, wm, sent};
    sparse_fold_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)cp, (const int32_t*)mcnt, (const uint8_t*)ofc,
        (const int32_t*)grp2, (const int32_t*)d_tax4,
        (const float*)weights, p, (int32_t*)tab, (int32_t*)mk, (float*)mv,
        (uint8_t*)multi_of);
    return (int)cudaGetLastError();
}
