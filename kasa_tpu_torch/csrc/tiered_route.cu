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
// shared memory, so this arm could take C < 12,000 chunks (48 KB, the
// default a block may use); but its counters grow with C and M (at C =
// 20,000 and M = 8.5 M windows, 166 M of them) and one block scans them,
// so on the H100 it only wins below 8 chunks.
//
// The global arm, for more chunks (the wrapper picks the arm from C,
// kernels.tiered_route_arm), sorts instead:
//   bins:    one thread per window writes its bin (the same upper bound
//            over chunk_limb0, C int32 that stay in L2) and its position;
//   sort:    radix.cuh's one-sweep passes sort the (bin, position) pairs
//            by bin, stably, over the bits of C only (two 8-bit passes
//            up to 65,535 chunks), so positions keep window order;
//   gather:  one thread per routed slot i copies window pos[i] and its
//            validity bits; cuts come from the sorted bins: the chunks
//            c with sorted bin i-1 <= c < sorted bin i start at i (slot
//            M closes the last ones).
// Its traffic is the windows once and the routed copy once, plus 8
// bytes a window per pass each way.
#include "radix.cuh"

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

// validity bits: bit ki set while no letter min_k-1 .. k-1 is '^' (code
// 30), k = max_k - ki (tiered.py:166-175)
__device__ __forceinline__ int window_vbits(int2 w, int min_k, int max_k) {
    int vb = 0;
    bool ok = true;
    for (int pos = min_k - 1; pos < max_k; ++pos) {
        const int limb = pos < 6 ? w.x : w.y;
        const int shift = 5 * (5 - pos % 6);
        ok = ok && (((limb >> shift) & 31) != 30);
        if (ok) vb |= 1 << (max_k - (pos + 1));
    }
    return vb;
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
            qr[dst] = w;
            vbr[dst] = window_vbits(w, min_k, max_k);
            posr[dst] = (int32_t)m;
        }
        __syncwarp();
        if (b >= 0 && lane == __ffs(peers) - 1) off[b] += __popc(peers);
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// the global arm

__global__ void route_bins_kernel(const int2* __restrict__ q,
                                  const int32_t* __restrict__ limb0,
                                  long long M, int C,
                                  int32_t* __restrict__ bins,
                                  int32_t* __restrict__ pos) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    bins[m] = bin_of(q[m].x, limb0, C);
    pos[m] = (int32_t)m;
}

__global__ void route_gather_kernel(const int2* __restrict__ q,
                                    const int32_t* __restrict__ sbins,
                                    const int32_t* __restrict__ spos,
                                    long long M, int C, int min_k, int max_k,
                                    int2* __restrict__ qr,
                                    int32_t* __restrict__ vbr,
                                    int32_t* __restrict__ posr,
                                    int32_t* __restrict__ cuts) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i > M) return;
    // chunk c starts at the first slot whose bin exceeds c
    const int lo = i == 0 ? 0 : sbins[i - 1];
    const int hi = i == M ? C : sbins[i];
    for (int c = lo; c < hi; ++c) cuts[c] = (int32_t)i;
    if (i == M) return;
    const int32_t m = spos[i];
    const int2 w = q[m];
    qr[i] = w;
    vbr[i] = window_vbits(w, min_k, max_k);
    posr[i] = m;
}

// bits of a bin: bins run 0..C
inline int bin_bits(int C) {
    int b = 1;
    while (b < 31 && (1LL << b) <= C) ++b;
    return b;
}

}  // namespace

// -> the digit passes of the global arm's sort of M windows over C
// chunks; *scratch_words: the int32 words of its scratch (four M-word
// buffers of bins and positions, then the sort's own)
extern "C" int kasa_tiered_route_global_plan(long long M, int C,
                                             long long* scratch_words) {
    *scratch_words = 4 * M + rows_radix_scratch_words(M, 1);
    return rows_radix_passes(1, 0, bin_bits(C));
}

extern "C" int kasa_tiered_route_global(const void* q, const void* limb0,
                                        long long M, int C, int min_k,
                                        int max_k, void* scratch, void* qr,
                                        void* vbr, void* posr, void* cuts,
                                        void* stream) {
    if (C < 1 || M < 0 || M >= (1LL << 31) || min_k < 1 || max_k > 12
        || min_k > max_k)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* w = (int32_t*)scratch;
    int32_t *bins = w, *pos = w + M, *ba = w + 2 * M, *pa = w + 3 * M;
    const int32_t* sb = bins;
    const int32_t* sp = pos;
    if (M > 0) {
        route_bins_kernel<<<(unsigned)((M + 255) / 256), 256, 0, st>>>(
            (const int2*)q, (const int32_t*)limb0, M, C, bins, pos);
        // pass p writes (ba, pa) when p is even, else (bins, pos)
        const int bits = bin_bits(C);
        const int err = rows_radix_sort(bins, pos, ba, pa, bins, pos,
                                        w + 4 * M, M, 1, 0, st, nullptr,
                                        bits);
        if (err != 0) return err;
        if (rows_radix_passes(1, 0, bits) % 2 == 1) {
            sb = ba;
            sp = pa;
        }
    }
    route_gather_kernel<<<(unsigned)((M + 256) / 256), 256, 0, st>>>(
        (const int2*)q, sb, sp, M, C, min_k, max_k, (int2*)qr,
        (int32_t*)vbr, (int32_t*)posr, (int32_t*)cuts);
    return (int)cudaGetLastError();
}

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
