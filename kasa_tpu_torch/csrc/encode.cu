// K1 encode: padded DNA read rows -> L 30-bit limbs per window.
//
// Replaces kasa_tpu/core/encode.py:52 dna_to_aa_codes and :70
// encode_windows together with the windowing prologue of
// kasa_tpu/match/turbo.py:1206-1216 (fused_turbo_acc): the codon LUT
// gather per position, highestK letters at stride 3 packed into
// L = ceil(highestK / 6) int32 limbs of six 5-bit letters (the last limb
// holds the rest: two full limbs at highestK = 12, five limbs at 25 with
// one letter in the last), and the first W windows of every row.  Two
// more arms of the same prologue: protein input (-z, letter = byte & 31
// at stride 1, dna_to_aa_codes(protein=True)) and one frame (--one,
// JAX's win[:, ::3]: window c starts at byte 3c).
//
// Bound on the H100: memory.  Per window it reads 3 * highestK bytes of
// its row and writes 4 * L bytes; neighbouring windows share all but one
// of their bytes, so the row bytes come from L1/L2 and device memory sees
// each byte about once (rows*maxlen in, rows*W*4*L out).  The 512-entry
// LUT lives in shared memory.
//
// Design: one thread per window, windows of a row adjacent in the grid
// (the L stores of neighbouring threads are contiguous).  A window never
// reads past its row: the wrapper checks (W-1)*step + span <= maxlen
// (DNA: span 3 * highestK, so for W = maxlen - span + 1 the last triplet
// ends at maxlen - 1; one frame: step 3 and W = maxlen/3 - highestK + 1;
// protein: span highestK).  Hash indices past the LUT clamp to its last
// entry, as kasa_tpu's gather does.
//
// Sloppy arm (-j; kasa_tpu/core/encode.py:103 sloppy_reduce, applied
// inside encode_windows at :98-99): with a 1,024-entry pair LUT, the 12
// letters of a 64-bit window fold pairwise into six, limb 0 holds them
// and limb 1 is 0.  The LUT sits in shared memory beside the codon LUT;
// the fold works on the two limbs in registers, so the arm adds no
// device-memory traffic (it writes the same 8 bytes per window).
#include "common.cuh"

namespace {

constexpr int kLutMax = 512;
constexpr int kAasN = 1024;
constexpr int kMaxLimbs = 5;

__global__ void encode_kernel(const uint8_t* __restrict__ mat,
                              const int32_t* __restrict__ lut, int lut_n,
                              int rows, int maxlen, int w, int protein,
                              int step, int hk, int L,
                              const int32_t* __restrict__ aas,
                              int32_t* __restrict__ out) {
    __shared__ int32_t slut[kLutMax];
    __shared__ int32_t saas[kAasN];
    for (int i = threadIdx.x; i < kLutMax; i += blockDim.x)
        slut[i] = lut[min(i, lut_n - 1)];
    if (aas != nullptr)
        for (int i = threadIdx.x; i < kAasN; i += blockDim.x)
            saas[i] = aas[i];
    __syncthreads();
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= (long long)rows * w) return;
    const long long r = m / w;
    const int c = (int)(m - r * w);
    const uint8_t* p = mat + r * maxlen + (long long)c * step;
    // each limb is stored once its sixth (or the last) letter is in:
    // no per-thread array, so nothing spills to local memory
    int32_t* o = out + m * L;
    int32_t limb = 0;
    if (aas != nullptr) {
        // the sloppy arm (hk == 12, L == 2): both limbs in registers,
        // then letter pairs (2p, 2p + 1) -> letter p of limb 0
        int32_t l2[2] = {0, 0};
        for (int j = 0; j < 12; ++j) {
            int32_t code;
            if (protein) {
                code = p[j] & 31;
            } else {
                const int c1 = p[3 * j], c2 = p[3 * j + 1],
                          c3 = p[3 * j + 2];
                code = slut[((c1 & 14) << 5) | ((c2 & 14) << 2)
                            | ((c3 & 14) >> 1)];
            }
            l2[j / 6] |= code << (5 * (5 - (j % 6)));
        }
        int32_t red = 0;
#pragma unroll
        for (int pr = 0; pr < 6; ++pr) {
            const int a = 2 * pr, b = 2 * pr + 1;
            const int ca = (l2[a / 6] >> (5 * (5 - a % 6))) & 31;
            const int cb = (l2[b / 6] >> (5 * (5 - b % 6))) & 31;
            red |= saas[(ca << 5) | cb] << (5 * (5 - pr));
        }
        o[0] = red;
        o[1] = 0;
        return;
    }
    for (int j = 0; j < hk; ++j) {
        int32_t code;
        if (protein) {
            code = p[j] & 31;
        } else {
            const int c1 = p[3 * j], c2 = p[3 * j + 1], c3 = p[3 * j + 2];
            const int idx = ((c1 & 14) << 5) | ((c2 & 14) << 2)
                            | ((c3 & 14) >> 1);
            code = slut[idx];                 // idx <= 511 < kLutMax
        }
        limb |= code << (5 * (5 - (j % 6)));
        if (j % 6 == 5 || j == hk - 1) {
            o[j / 6] = limb;
            limb = 0;
        }
    }
}

}  // namespace

extern "C" int kasa_encode_windows(const void* mat, const void* lut,
                                   int lut_n, int rows, int maxlen, int w,
                                   int protein, int step, int hk,
                                   const void* aas, void* out,
                                   void* stream) {
    const int L = (hk + 5) / 6;
    if (hk < 1 || L > kMaxLimbs) return (int)cudaErrorInvalidValue;
    if (aas != nullptr && hk != 12) return (int)cudaErrorInvalidValue;
    const long long m = (long long)rows * w;
    if (m > 0) {
        const int threads = 256;
        const long long blocks = (m + threads - 1) / threads;
        encode_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
            (const uint8_t*)mat, (const int32_t*)lut, lut_n, rows, maxlen,
            w, protein, step, hk, L, (const int32_t*)aas, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
