// K5 dedup: -e (unique k-mers per read) on the read-major window limbs.
//
// Replaces kasa_tpu/match/turbo.py:128 dedup_read_windows: per read, all
// kpr windows (every line of the read: both frames' rows under --six,
// both mates of a pair) sorted by (limb0, limb1) ascending, and every
// window equal to its predecessor set to POISON_LIMB in both limbs (six
// '^' letters, which self-mask at every k).  The sorted order is the
// output: K4's budget cut admits the first slots of a T in read order,
// so the layout must be JAX's for the overflow flags to match.
//
// Bound on the H100: memory, M * 8 bytes in and M * 8 out (M = R * kpr
// windows); the sort itself runs in shared memory.
//
// Design: one block per read.  Limbs are non-negative 30-bit values, so
// the 60-bit key limb0 << 30 | limb1 orders exactly as JAX's signed
// two-key sort.  The read's keys, padded with INT64_MAX to the next
// power of two P >= kpr (P <= 4096: 32 KB), are sorted by the bitonic
// sort of common.cuh; a window is a duplicate when its key equals the
// key before it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kPad = 0x7fffffffffffffffLL;
constexpr long long kLimbMask = (1LL << 30) - 1;

__global__ void dedup_kernel(const int2* __restrict__ q, int kpr, int P,
                             int poison, int2* __restrict__ out) {
    extern __shared__ long long keys[];
    const int tid = threadIdx.x;
    const long long base = (long long)blockIdx.x * kpr;
    for (int i = tid; i < P; i += kThreads) {
        long long k = kPad;
        if (i < kpr) {
            const int2 v = q[base + i];
            k = ((long long)v.x << 30) | (long long)v.y;
        }
        keys[i] = k;
    }
    __syncthreads();
    block_bitonic_sort<long long, kThreads>(keys, P);
    for (int i = tid; i < kpr; i += kThreads) {
        const long long k = keys[i];
        const bool dup = i > 0 && keys[i - 1] == k;
        out[base + i] = dup ? make_int2(poison, poison)
                            : make_int2((int)(k >> 30), (int)(k & kLimbMask));
    }
}

}  // namespace

extern "C" int kasa_dedup_windows(const void* q, int R, int kpr, int P,
                                  int poison, void* out, void* stream) {
    if (P < kpr || (P & (P - 1)) != 0 || P > 4096)
        return (int)cudaErrorInvalidValue;
    if (R > 0 && kpr > 0) {
        dedup_kernel<<<R, kThreads, (size_t)P * sizeof(long long),
                       (cudaStream_t)stream>>>(
            (const int2*)q, kpr, P, poison, (int2*)out);
    }
    return (int)cudaGetLastError();
}
