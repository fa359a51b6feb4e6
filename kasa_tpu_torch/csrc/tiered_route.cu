// K7 tiered_route: the windows of a batch routed to the index chunks.
//
// Replaces kasa_tpu/match/tiered.py:140 tiered_prepare (after its
// windowing, which K1 and K5 do here: the per-window validity bits of
// 166-175 and the global sort of the windows by full key, 177-180) and
// tiered.py:184 chunk_cuts (the searchsorted of every chunk's first
// limb0 in the sorted windows).  kasa_tpu sorts all M windows only so
// that a chunk's windows form one contiguous range: nothing after it
// depends on the order inside a chunk (T1 keys go back to the window's
// own position, the big flags are a max, the multi sums float adds).
// So the windows are routed instead: window m belongs to bin b = the
// number of chunks whose first limb0 is <= its limb0 (bin 0: below the
// first chunk, never searched, as in kasa_tpu); the routed array holds
// bin 0, then chunk 0, ..., chunk C-1, each in window order, and
// cuts[c] = the first position of chunk c = kasa_tpu's cuts[c] exactly.
//
// Three launches (K4's precedent: a histogram and a scan in place of a
// global stable sort):
//   count:   one warp per segment of 1024 windows counts its windows per
//            bin in shared memory (__match_any_sync groups a step's 32
//            lanes by bin); counts land bin-major, (C+1) x nseg;
//   scan:    one block turns the counts into exclusive offsets (bin-major
//            order makes them the global destinations) and writes cuts;
//   scatter: each warp walks its segment again in order, a lane's
//            destination its bin's running offset plus its rank among
//            the step's lanes of that bin: a stable scatter of (limbs,
//            validity bits, window position).
//
// Bound on the H100: memory.  The least traffic is each window read once
// (8 bytes) and its routed copy written once (16 bytes); the count pass
// reads the windows a second time (24 + 8 bytes per window moved) and
// the scan's (C+1) x nseg counters are a few hundred KB.  One warp per
// block keeps the running offsets of all C+1 bins in 4(C+1) bytes of
// shared memory (C < 12,000 chunks).
#include "common.cuh"

namespace {

constexpr int kSeg = 1024;           // windows per segment (one warp)
constexpr int kScanThreads = 1024;

// bin of a window: chunks whose first limb0 is <= qh (upper bound)
__device__ __forceinline__ int bin_of(int32_t qh,
                                      const int32_t* __restrict__ limb0,
                                      int C) {
    int lo = 0, hi = C;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(&limb0[mid]) <= qh) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__global__ void route_count_kernel(const int2* __restrict__ q,
                                   const int32_t* __restrict__ limb0,
                                   long long M, int C, int nseg,
                                   int32_t* __restrict__ hist) {
    extern __shared__ int32_t cnt[];   // C + 1
    const int lane = threadIdx.x;
    const int seg = blockIdx.x;
    for (int b = lane; b <= C; b += 32) cnt[b] = 0;
    __syncwarp();
    const long long base = (long long)seg * kSeg;
    for (int s = 0; s < kSeg; s += 32) {
        const long long m = base + s + lane;
        const int b = m < M ? bin_of(q[m].x, limb0, C) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, b);
        if (b >= 0 && lane == __ffs(peers) - 1) cnt[b] += __popc(peers);
        __syncwarp();
    }
    for (int b = lane; b <= C; b += 32)
        hist[(long long)b * nseg + seg] = cnt[b];
}

__global__ void route_scan_kernel(int32_t* __restrict__ hist, long long n,
                                  int C, int nseg,
                                  int32_t* __restrict__ cuts) {
    __shared__ long long buf[kScanThreads];
    const int tid = threadIdx.x;
    const long long chunk = (n + kScanThreads - 1) / kScanThreads;
    const long long i0 = min((long long)tid * chunk, n);
    const long long i1 = min(i0 + chunk, n);
    long long local = 0;
    for (long long i = i0; i < i1; ++i) local += hist[i];
    long long total;
    long long run = block_exclusive_scan<kScanThreads>(local, buf, &total);
    for (long long i = i0; i < i1; ++i) {
        const int32_t v = hist[i];
        hist[i] = (int32_t)run;
        run += v;
    }
    __syncthreads();
    // chunk c starts where bin c + 1 does
    for (int c = tid; c < C; c += kScanThreads)
        cuts[c] = hist[(long long)(c + 1) * nseg];
}

__global__ void route_scatter_kernel(const int2* __restrict__ q,
                                     const int32_t* __restrict__ limb0,
                                     long long M, int C, int nseg,
                                     int min_k, int max_k,
                                     const int32_t* __restrict__ hist,
                                     int2* __restrict__ qr,
                                     int32_t* __restrict__ vbr,
                                     int32_t* __restrict__ posr) {
    extern __shared__ int32_t off[];   // C + 1 running offsets
    const int lane = threadIdx.x;
    const int seg = blockIdx.x;
    for (int b = lane; b <= C; b += 32)
        off[b] = hist[(long long)b * nseg + seg];
    __syncwarp();
    const long long base = (long long)seg * kSeg;
    for (int s = 0; s < kSeg; s += 32) {
        const long long m = base + s + lane;
        int2 w = make_int2(0, 0);
        int b = -1;
        if (m < M) {
            w = q[m];
            b = bin_of(w.x, limb0, C);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, b);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        if (b >= 0) {
            const int dst = off[b] + rank;
            // validity bits: bit ki set while no letter min_k-1 .. k-1
            // is '^' (code 30), k = max_k - ki (tiered.py:166-175)
            int vb = 0;
            bool ok = true;
            for (int pos = min_k - 1; pos < max_k; ++pos) {
                const int limb = pos < 6 ? w.x : w.y;
                const int shift = 5 * (5 - pos % 6);
                ok = ok && (((limb >> shift) & 31) != 30);
                if (ok) vb |= 1 << (max_k - (pos + 1));
            }
            qr[dst] = w;
            vbr[dst] = vb;
            posr[dst] = (int32_t)m;
        }
        __syncwarp();
        if (b >= 0 && lane == __ffs(peers) - 1) off[b] += __popc(peers);
        __syncwarp();
    }
}

}  // namespace

extern "C" int kasa_tiered_route(const void* q, const void* limb0,
                                 long long M, int C, int nseg, int min_k,
                                 int max_k, void* hist, void* qr, void* vbr,
                                 void* posr, void* cuts, void* stream) {
    if (C < 1 || nseg < 1 || (long long)nseg * kSeg < M || min_k < 1
        || max_k > 12 || min_k > max_k)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(C + 1) * sizeof(int32_t);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    route_count_kernel<<<nseg, 32, smem, st>>>(
        (const int2*)q, (const int32_t*)limb0, M, C, nseg, (int32_t*)hist);
    route_scan_kernel<<<1, kScanThreads, 0, st>>>(
        (int32_t*)hist, (long long)(C + 1) * nseg, C, nseg, (int32_t*)cuts);
    route_scatter_kernel<<<nseg, 32, smem, st>>>(
        (const int2*)q, (const int32_t*)limb0, M, C, nseg, min_k, max_k,
        (const int32_t*)hist, (int2*)qr, (int32_t*)vbr, (int32_t*)posr);
    return (int)cudaGetLastError();
}
