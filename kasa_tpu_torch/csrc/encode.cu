// K1 encode: padded DNA read rows -> two 30-bit limbs per window.
//
// Replaces kasa_tpu/core/encode.py:52 dna_to_aa_codes and :70
// encode_windows together with the windowing prologue of
// kasa_tpu/match/turbo.py:1206-1216 (fused_turbo_acc): the codon LUT
// gather per position, 12 letters at stride 3 packed into two int32
// limbs, and the first W windows of every row.  Two more arms of the
// same prologue: protein input (-z, letter = byte & 31 at stride 1,
// dna_to_aa_codes(protein=True)) and one frame (--one, JAX's
// win[:, ::3]: window c starts at byte 3c).
//
// Bound on the H100: memory.  Per window it reads 36 bytes of its row
// and writes 8 bytes; neighbouring windows share 35 of their 36 bytes,
// so the row bytes come from L1/L2 and device memory sees each byte
// about once (rows*maxlen in, rows*W*8 out).  The 512-entry LUT lives
// in shared memory.
//
// Design: one thread per window, windows of a row adjacent in the grid
// (coalesced 8-byte stores).  A window never reads past its row: the
// wrapper checks (W-1)*step + span <= maxlen (DNA: span 36, so for
// W = maxlen - 35 the last triplet ends at maxlen - 1; one frame: step
// 3 and W = maxlen/3 - 11; protein: span 12).  Hash indices past the
// LUT clamp to its last entry, as kasa_tpu's gather does.
#include "common.cuh"

namespace {

constexpr int kLutMax = 512;

__global__ void encode_kernel(const uint8_t* __restrict__ mat,
                              const int32_t* __restrict__ lut, int lut_n,
                              int rows, int maxlen, int w, int protein,
                              int step, int2* __restrict__ out) {
    __shared__ int32_t slut[kLutMax];
    for (int i = threadIdx.x; i < kLutMax; i += blockDim.x)
        slut[i] = lut[min(i, lut_n - 1)];
    __syncthreads();
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= (long long)rows * w) return;
    const long long r = m / w;
    const int c = (int)(m - r * w);
    const uint8_t* p = mat + r * maxlen + (long long)c * step;
    int32_t limb[2] = {0, 0};
    if (protein) {
#pragma unroll
        for (int j = 0; j < 12; ++j)
            limb[j / 6] |= (p[j] & 31) << (5 * (5 - (j % 6)));
    } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) {
            const int c1 = p[3 * j], c2 = p[3 * j + 1], c3 = p[3 * j + 2];
            const int idx = ((c1 & 14) << 5) | ((c2 & 14) << 2)
                            | ((c3 & 14) >> 1);
            const int32_t code = slut[idx];   // idx <= 511 < kLutMax
            limb[j / 6] |= code << (5 * (5 - (j % 6)));
        }
    }
    out[m] = make_int2(limb[0], limb[1]);
}

}  // namespace

extern "C" int kasa_encode_windows(const void* mat, const void* lut,
                                   int lut_n, int rows, int maxlen, int w,
                                   int protein, int step, void* out,
                                   void* stream) {
    const long long m = (long long)rows * w;
    if (m > 0) {
        const int threads = 256;
        const long long blocks = (m + threads - 1) / threads;
        encode_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
            (const uint8_t*)mat, (const int32_t*)lut, lut_n, rows, maxlen,
            w, protein, step, (int2*)out);
    }
    return (int)cudaGetLastError();
}
