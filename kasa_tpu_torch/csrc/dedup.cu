// K5 dedup: -e (unique k-mers per read) on the read-major window limbs.
//
// Replaces kasa_tpu/match/turbo.py:128 dedup_read_windows: per read, all
// kpr windows (every line of the read: both frames' rows under --six,
// both mates of a pair) sorted by (limb0, ..., limb L-1) ascending, and
// every window equal to its predecessor set to POISON_LIMB in all its
// limbs (six '^' letters, which self-mask at every k).  The sorted order
// is the output: K4's budget cut admits the first slots of a T in read
// order, so the layout must be JAX's for the overflow flags to match.
//
// Bound on the H100: memory, M * 4L bytes in and M * 4L out (M = R * kpr
// windows); the sort itself runs in shared memory in the first two arms.
//
// Three arms, chosen by the wrapper from (kpr, L)
// (kasa_tpu_torch/kernels.py dedup_arm), each one block per read:
//   short   kpr <= 4096 (P, the next power of two, at most 4096): the
//           read's windows, padded with rows of INT32_MAX to P, sorted as
//           rows of L limbs by a bitonic sort in shared memory that
//           compares limb by limb, P * 4L bytes (80 KB at L = 5).  Limbs
//           are non-negative 30-bit values, so this orders exactly like
//           JAX's L-key signed sort (equal windows are equal in every
//           limb, so the sort's instability changes nothing).
//   long    longer reads whose rows fit in one block's shared memory,
//           kpr * (4L + 4) + kLongFixed bytes (up to 18,682 windows at
//           L = 2, 9,341 at L = 5 on the H100: kasa_dedup_long_max_kpr
//           gives the card's figure): the rows are loaded once, coalesced,
//           and an array of 16-bit row indices is sorted by LSD radix
//           passes over 8-bit digits, last limb first, between two index
//           buffers.  A pass counts each warp's digits over its chunk of
//           the indices (warp peers by ballots), scans the (digit, warp)
//           counts in one block scan, and sends every index to its
//           digit's start plus its warp's offset plus its rank among the
//           warp's earlier indices of that digit: stable.  Writes are
//           coalesced.
//   global  the rest (--six on an 8 kbp line at L = 5, long pairs under
//           --six): every read's windows sorted in global memory by
//           radix.cuh's seg_radix_sort (four 8-bit digit passes per limb,
//           from the last limb to the first, into a scratch buffer and
//           the output), then one thread per window writes it, or
//           POISON_LIMB, to the output.
// In every arm a window is a duplicate when it equals the row before it.
#include "radix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLimbs = 5;

template <int L>
__device__ __forceinline__ bool row_greater(const int32_t* a,
                                            const int32_t* b) {
    bool gt = a[L - 1] > b[L - 1];
#pragma unroll
    for (int i = L - 2; i >= 0; --i)
        gt = (a[i] > b[i]) || (a[i] == b[i] && gt);
    return gt;
}

template <int L>
__global__ void dedup_kernel(const int32_t* __restrict__ q, int kpr, int P,
                             int poison, int32_t* __restrict__ out) {
    extern __shared__ int32_t rows[];          // P * L limbs
    const int tid = threadIdx.x;
    const long long base = (long long)blockIdx.x * kpr * L;
    for (int i = tid; i < P * L; i += kThreads)
        rows[i] = i < kpr * L ? q[base + i] : KASA_I32_MAX;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < P; i += kThreads) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    int32_t* a = rows + i * L;
                    int32_t* b = rows + ixj * L;
                    if (row_greater<L>(a, b) == ((i & k) == 0)) {
#pragma unroll
                        for (int l = 0; l < L; ++l) {
                            const int32_t t = a[l];
                            a[l] = b[l];
                            b[l] = t;
                        }
                    }
                }
            }
            __syncthreads();
        }
    }
    for (int i = tid; i < kpr; i += kThreads) {
        const int32_t* a = rows + i * L;
        const int32_t* b = rows + max(i - 1, 0) * L;
        bool dup = i > 0;
#pragma unroll
        for (int l = 0; l < L; ++l) dup = dup && a[l] == b[l];
#pragma unroll
        for (int l = 0; l < L; ++l)
            out[base + (long long)i * L + l] = dup ? poison : a[l];
    }
}

template <int L>
int launch(const void* q, int R, int kpr, int P, int poison, void* out,
           cudaStream_t st) {
    const size_t smem = (size_t)P * L * sizeof(int32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            dedup_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dedup_kernel<L><<<R, kThreads, smem, st>>>(
        (const int32_t*)q, kpr, P, poison, (int32_t*)out);
    return (int)cudaGetLastError();
}

// the global arm's last step: srt holds every read's windows sorted
template <int L>
__global__ void poison_dups_kernel(const int32_t* __restrict__ srt, int kpr,
                                   long long M, int poison,
                                   int32_t* __restrict__ out) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    const int32_t* a = srt + m * L;
    bool dup = m % kpr != 0;
#pragma unroll
    for (int l = 0; l < L; ++l) dup = dup && a[l] == a[l - L];
#pragma unroll
    for (int l = 0; l < L; ++l) out[m * L + l] = dup ? poison : a[l];
}

template <int L>
int launch_global(const void* q, int R, int kpr, int poison, void* scratch,
                  void* out, cudaStream_t st) {
    int cols[4 * kMaxLimbs], shifts[4 * kMaxLimbs], passes = 0;
    for (int c = L - 1; c >= 0; --c)
        for (int sh = 0; sh < 32; sh += 8) {
            cols[passes] = c;
            shifts[passes++] = sh;
        }
    // 4L passes, an even number: q -> out -> scratch -> ... -> scratch
    const int32_t* srt = seg_radix_sort<L>(
        (const int32_t*)q, (int32_t*)out, (int32_t*)scratch, R, kpr, cols,
        shifts, passes, st);
    const long long M = (long long)R * kpr;
    poison_dups_kernel<L><<<(unsigned)((M + 255) / 256), 256, 0, st>>>(
        srt, kpr, M, poison, (int32_t*)out);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the shared-memory arm

constexpr int kLongThreads = 512;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kLongRadix = 256;
// shared memory besides the rows and indices: the (digit, warp) counts
// and the block scan's warp sums
constexpr int kLongFixed = kLongRadix * kLongWarps * 2 + kLongWarps * 4;

template <int L>
__global__ void __launch_bounds__(kLongThreads) dedup_long_kernel(
        const int32_t* __restrict__ q, int kpr, int poison,
        int32_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char long_smem[];
    // cnt[d * kLongWarps + w]: digit d in warp w's chunk, then, scanned,
    // where warp w's next index of digit d goes
    unsigned short* cnt = reinterpret_cast<unsigned short*>(long_smem);
    int* sums = reinterpret_cast<int*>(cnt + kLongRadix * kLongWarps);
    int32_t* rows = reinterpret_cast<int32_t*>(long_smem + kLongFixed);
    unsigned short* cur = reinterpret_cast<unsigned short*>(rows + kpr * L);
    unsigned short* nxt = cur + kpr;
    const int tid = threadIdx.x;
    const unsigned lane = tid & 31u;
    const unsigned lt = (1u << lane) - 1u;
    const int warp = tid >> 5;
    const long long base = (long long)blockIdx.x * kpr * L;
    for (int i = tid; i < kpr * L; i += kLongThreads) rows[i] = q[base + i];
    for (int i = tid; i < kpr; i += kLongThreads)
        cur[i] = (unsigned short)i;
    // warp w takes indices [w, w + 1) x 32 per, item by item
    const int per = (kpr + kLongThreads - 1) / kLongThreads;
    const int lo = warp * 32 * per;
    constexpr int kScan = kLongRadix * kLongWarps / kLongThreads;
    for (int c = L - 1; c >= 0; --c) {
        for (int sh = 0; sh < 30; sh += 8) {
            for (int i = tid; i < kLongRadix * kLongWarps; i += kLongThreads)
                cnt[i] = 0;
            __syncthreads();
            for (int it = 0; it < per; ++it) {
                const int p = lo + it * 32 + (int)lane;
                const bool valid = p < kpr;
                const unsigned d = valid
                    ? ((unsigned)rows[cur[p] * L + c] >> sh) & 255u : 0u;
                const unsigned peers = warp_peers<8>(d, valid);
                if (valid && (peers & lt) == 0)
                    cnt[d * kLongWarps + warp] += __popc(peers);
                __syncwarp();
            }
            __syncthreads();
            // exclusive scan of the counts in (digit, warp) order: each
            // thread kScan consecutive entries
            unsigned short v[kScan];
            int mine = 0;
#pragma unroll
            for (int k = 0; k < kScan; ++k) {
                v[k] = cnt[tid * kScan + k];
                mine += v[k];
            }
            int total;
            int run = block_scan_excl<kLongThreads>(mine, sums, &total);
#pragma unroll
            for (int k = 0; k < kScan; ++k) {
                cnt[tid * kScan + k] = (unsigned short)run;
                run += v[k];
            }
            __syncthreads();
            for (int it = 0; it < per; ++it) {
                const int p = lo + it * 32 + (int)lane;
                const bool valid = p < kpr;
                const unsigned short r = valid ? cur[p] : 0;
                const unsigned d = valid
                    ? ((unsigned)rows[r * L + c] >> sh) & 255u : 0u;
                const unsigned peers = warp_peers<8>(d, valid);
                const unsigned before = valid ? cnt[d * kLongWarps + warp]
                                              : 0u;
                __syncwarp();
                if (valid && (peers & lt) == 0)
                    cnt[d * kLongWarps + warp] =
                        (unsigned short)(before + __popc(peers));
                __syncwarp();
                if (valid) nxt[before + __popc(peers & lt)] = r;
            }
            __syncthreads();
            unsigned short* t = cur;
            cur = nxt;
            nxt = t;
        }
    }
    for (int j = tid; j < kpr * L; j += kLongThreads) {
        const int i = j / L;
        const int32_t* a = rows + cur[i] * L;
        bool dup = i > 0;
        if (dup) {
            const int32_t* b = rows + cur[i - 1] * L;
#pragma unroll
            for (int l = 0; l < L; ++l) dup = dup && a[l] == b[l];
        }
        out[base + j] = dup ? poison : a[j - i * L];
    }
}

template <int L>
int launch_long(const void* q, int R, int kpr, int poison, void* out,
                cudaStream_t st) {
    const size_t smem = kLongFixed + (size_t)kpr * (4 * L + 4);
    const cudaError_t e = cudaFuncSetAttribute(
        dedup_long_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dedup_long_kernel<L><<<R, kLongThreads, smem, st>>>(
        (const int32_t*)q, kpr, poison, (int32_t*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kasa_dedup_windows_long(const void* q, int R, int kpr, int L,
                                       int poison, void* out, void* stream) {
    // the block's shared memory must hold the rows and indices: a longer
    // read fails to launch (the wrapper sends it to the global arm)
    if (L < 2 || L > kMaxLimbs || kpr < 1 || kpr > 65535)
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch_long<2>(q, R, kpr, poison, out, st);
        case 3: return launch_long<3>(q, R, kpr, poison, out, st);
        case 4: return launch_long<4>(q, R, kpr, poison, out, st);
        default: return launch_long<5>(q, R, kpr, poison, out, st);
    }
}

// The most windows a read may have for the shared-memory arm at L limbs
// on the card `device` (the wrapper picks the arm by it), or minus a CUDA
// error.
extern "C" int kasa_dedup_long_max_kpr(int L, int device) {
    if (L < 2 || L > kMaxLimbs) return -(int)cudaErrorInvalidValue;
    int smem = 0;
    const cudaError_t e = cudaDeviceGetAttribute(
        &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return -(int)e;
    const int n = (smem - kLongFixed) / (4 * L + 4);
    return n < 65535 ? n : 65535;     // 16-bit row indices
}

extern "C" int kasa_dedup_windows_global(const void* q, int R, int kpr,
                                         int L, int poison, void* scratch,
                                         void* out, void* stream) {
    // scratch: (R * kpr, L) int32, the digit passes' second buffer
    if (L < 2 || L > kMaxLimbs || kpr < 1) return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch_global<2>(q, R, kpr, poison, scratch, out, st);
        case 3: return launch_global<3>(q, R, kpr, poison, scratch, out, st);
        case 4: return launch_global<4>(q, R, kpr, poison, scratch, out, st);
        default:
            return launch_global<5>(q, R, kpr, poison, scratch, out, st);
    }
}

extern "C" int kasa_dedup_windows(const void* q, int R, int kpr, int L,
                                  int P, int poison, void* out,
                                  void* stream) {
    if (P < kpr || (P & (P - 1)) != 0 || P > 4096 || L < 2
        || L > kMaxLimbs)
        return (int)cudaErrorInvalidValue;
    if (R <= 0 || kpr <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch<2>(q, R, kpr, P, poison, out, st);
        case 3: return launch<3>(q, R, kpr, P, poison, out, st);
        case 4: return launch<4>(q, R, kpr, P, poison, out, st);
        default: return launch<5>(q, R, kpr, P, poison, out, st);
    }
}
