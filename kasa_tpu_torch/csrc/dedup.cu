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
// windows); the sort itself runs in shared memory.
//
// Design: one block per read.  The read's windows, padded with rows of
// INT32_MAX to the next power of two P >= kpr, are sorted as rows of L
// limbs by a bitonic sort in shared memory that compares limb by limb.
// Limbs are non-negative 30-bit values, so this orders exactly like
// JAX's L-key signed sort (equal windows are equal in every limb, so the
// sort's instability changes nothing); a window is a duplicate when it
// equals the row before it.  The rows take P * 4L bytes of shared memory
// (32 KB at L = 2, 80 KB at L = 5 for P = 4096): the wrapper caps P at
// 4096 and the launcher raises the block's shared-memory limit past the
// 48 KB default when a launch needs it.  Reads of more than 4096
// windows (long read lines, -e under --six on long pairs) take the long
// arm: every read's windows are sorted in global memory by radix.cuh's
// seg_radix_sort (one block per read, four 8-bit digit passes per limb,
// from the last limb to the first, into a scratch buffer and the
// output), then one thread per window compares it with its predecessor
// in the read and writes it, or POISON_LIMB, to the output.
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

// the long arm's last step: srt holds every read's windows sorted
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
int launch_long(const void* q, int R, int kpr, int poison, void* scratch,
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

}  // namespace

extern "C" int kasa_dedup_windows_long(const void* q, int R, int kpr, int L,
                                       int poison, void* scratch, void* out,
                                       void* stream) {
    // scratch: (R * kpr, L) int32, the digit passes' second buffer
    if (L < 2 || L > kMaxLimbs || kpr < 1) return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (L) {
        case 2: return launch_long<2>(q, R, kpr, poison, scratch, out, st);
        case 3: return launch_long<3>(q, R, kpr, poison, scratch, out, st);
        case 4: return launch_long<4>(q, R, kpr, poison, scratch, out, st);
        default: return launch_long<5>(q, R, kpr, poison, scratch, out, st);
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
