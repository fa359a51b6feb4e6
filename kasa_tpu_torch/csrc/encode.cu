// K1 encode: padded DNA read rows -> L 30-bit limbs per window.
//
// Replaces kasa_tpu/core/encode.py:52 dna_to_aa_codes and :70
// encode_windows together with the windowing prologue of
// kasa_tpu/match/turbo.py:1206-1216 (fused_turbo_acc): the codon LUT
// gather per position, highestK letters at stride 3 packed into
// L = ceil(highestK / 6) int32 limbs of six 5-bit letters (the last limb
// holds the rest: two full limbs at highestK = 12, five limbs at 25 with
// one letter in the last), and the first W windows of every row.  Two
// more modes of the same prologue: protein input (-z, letter = byte & 31
// at stride 1, dna_to_aa_codes(protein=True)) and one frame (--one,
// JAX's win[:, ::3]: window c starts at byte 3c).  And the sloppy fold
// (-j; kasa_tpu/core/encode.py:103 sloppy_reduce, applied inside
// encode_windows at :98-99): with a 1,024-entry pair LUT the 12 letters
// of a 64-bit window fold pairwise into six, limb 0 holds them and
// limb 1 is 0.
//
// Bound on the H100: the bytes written.  A window reads one byte of new
// input and writes 4 * L bytes (rows * maxlen in, rows * W * 4 * L out).
// The first design, one thread a window building it from its own bytes,
// made 3 * highestK byte loads and highestK LUT lookups a window (75 and
// 25 at L = 5), the same codon looked up highestK times over, and stored
// L words a thread at a stride of 4 * L bytes: the per-batch engine's
// line buffer (one row of ~13 M windows at L = 5) took 5x its bound
// (PERF.md).
//
// Design: every mode is one stream of letter slots a row.  DNA: slot u
// of a row is the codon at bytes u .. u + 2, a window's letters lie 3
// slots apart (ls = 3).  One frame: slot u is the codon at bytes 3u ..
// 3u + 2, letters 1 slot apart.  Protein: slot u is byte u & 31, 1
// apart.  Window c of a row starts at slot c in every mode, so the
// windows of all rows are the slots x = row * U + c with c < w in one
// flat slot space, and the windows of a run of slots are one run of
// output rows.  A persistent grid of blocks, each copying the LUTs into
// shared memory once, walks tiles of kTile slots (a part of a long row,
// or several short rows) and per tile:
//   1. stages the bytes of the tile's slots and their halo (the slots a
//      window's letters reach past the tile) in shared memory, 4-byte
//      loads of neighbouring words;
//   2. computes each slot's letter code once (one LUT lookup, or & 31);
//   3. computes once a slot the pack of six letters from it,
//      p(x) = code[x] << 25 | code[x + ls] << 20 | ... | code[x + 5 ls];
//      under -j instead the folded letter of the pair at x,
//      f(x) = aas[code[x] << 5 | code[x + ls]];
//   4. forms window c's limb i as p(c + 6 ls i), the short last limb
//      with its unused letters masked, or the folded limb 0 from
//      f(c), f(c + 2 ls), ..., f(c + 10 ls), into shared memory;
//   5. writes the tile's (W, L) limbs, one contiguous run of the
//      output, with 16-byte stores of neighbouring words.
// The limb count and the fold are template parameters (the limb loops
// unrolled), a slot's (row, column) split is a multiply and a shift
// (FastDiv), and a DNA or protein slot is its byte: the per-slot work is
// a few shared-memory loads and stores, so that the tile keeps up with
// its stores.
// A window never reads past its row: the wrapper checks
// (W - 1) * step + span <= maxlen.  Letters past a row's end only reach
// the masked letters of a short limb; past the whole matrix they read
// as byte 0.  Hash indices past the LUT clamp to its last entry, as
// kasa_tpu's gather does.
#include "common.cuh"

namespace {

constexpr int kLutMax = 512;
constexpr int kAasN = 1024;
constexpr int kMaxLimbs = 5;
constexpr int kThreads = 256;
constexpr int kTile = 1024;                      // slots a tile
// packs a tile: its slots and the limb starts past them, 6 ls (L - 1)
constexpr int kPackMax = kTile + 18 * (kMaxLimbs - 1);
// codes a tile: its packs and the five letters past the last
constexpr int kCodeMax = kPackMax + 15;
// bytes a tile's codes cover: 3 a slot and 2 more at each row's end in
// one frame (maxlen - 3 U <= 2, a row of U >= 1 slots), the alignment
constexpr int kByteMax = 5 * kCodeMax + 16;

enum Mode { kDna = 0, kOneFrame = 1, kProtein = 2 };

// n / d for every 32-bit n by a multiply and a shift (Granlund and
// Montgomery's round-up method: s = ceil(log2 d), m = floor(2^32 (2^s -
// d) / d) + 1, n / d = (umulhi(n, m) + n) >> s in 33 bits): the slot ->
// (row, column) split takes no division instruction
struct FastDiv {
    unsigned d, m;
    int s;
};

FastDiv fast_div(unsigned d) {
    int s = 0;
    while (s < 32 && (1ull << s) < d) ++s;
    const unsigned long long m =
        ((1ull << 32) * ((1ull << s) - d)) / d + 1;
    return FastDiv{d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned div_of(const FastDiv& f, unsigned n) {
    return (unsigned)(((unsigned long long)__umulhi(n, f.m) + n) >> f.s);
}

struct Args {
    const uint8_t* mat;      // from the word of byte 0: byte b at b + mis
    const int32_t* lut;
    const int32_t* aas;      // the sloppy pair LUT, or null
    int32_t* out;
    long long nbytes;        // rows * maxlen
    long long slots;         // rows * U
    long long tiles;
    FastDiv U;               // slots a row
    int mis;                 // the matrix's offset in its first word
    int maxlen, w, mode, ls, last_mask, lut_n;
};

// the first byte of slot u of row r
__device__ __forceinline__ long long slot_byte(const Args& a, long long r,
                                               unsigned u) {
    return r * a.maxlen + (a.mode == kOneFrame ? 3LL * u : (long long)u);
}

// L limbs a window; SLOPPY: the folded limb 0 and a zero limb 1 (L = 2)
template <int L, bool SLOPPY>
__global__ void __launch_bounds__(kThreads) encode_kernel(Args a) {
    __shared__ int32_t slut[kLutMax];
    __shared__ int32_t saas[SLOPPY ? kAasN : 1];
    __shared__ __align__(16) uint8_t sbytes[kByteMax];
    __shared__ uint8_t scode[kCodeMax];
    __shared__ int32_t spack[kPackMax];
    __shared__ int32_t sout[kTile * L];
    const int tid = threadIdx.x;
    for (int i = tid; i < kLutMax; i += kThreads)
        slut[i] = a.lut[min(i, a.lut_n - 1)];
    if (SLOPPY)
        for (int i = tid; i < kAasN; i += kThreads) saas[i] = a.aas[i];
    const int ls = a.ls;
    const unsigned U = a.U.d;
    // the folded limb reaches f(c + 10 ls), a limb pack p(c + 6 ls i)
    const int npack = kTile + (SLOPPY ? 10 * ls : 6 * ls * (L - 1));
    const int ncode = npack + 5 * ls;
    const long long end = a.nbytes + a.mis;
    for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const long long s0 = tile * kTile;
        const long long r0 = s0 / U;
        const unsigned u0 = (unsigned)(s0 - r0 * U);
        const int ncur = (int)min((long long)ncode, a.slots - s0);
        // 1. the bytes of the slots [s0, s0 + ncur), from a 4-byte
        // boundary (offsets from the matrix's first word: bytes [mis,
        // end) are the matrix's)
        const long long b0 = slot_byte(a, r0, u0) + a.mis;
        const unsigned kl = (unsigned)ncur - 1u + u0;
        const unsigned dl = div_of(a.U, kl);
        const long long b1 = min(slot_byte(a, r0 + dl, kl - dl * U) + a.mis
                                 + (a.mode == kProtein ? 1 : 3), end);
        const long long ba = b0 & ~3LL;
        const int nb = (int)(b1 - ba), o0 = (int)(b0 - ba);
        __syncthreads();               // the last tile's reads are done
        for (int b = 4 * tid; b < nb; b += 4 * kThreads) {
            uint8_t* d = sbytes + b;
            const long long g = ba + b;
            if (g >= a.mis && g + 4 <= end) {
                *reinterpret_cast<uint32_t*>(d) =
                    __ldg(reinterpret_cast<const uint32_t*>(a.mat + g));
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    d[k] = g + k >= a.mis && g + k < end ? a.mat[g + k] : 0;
            }
        }
        __syncthreads();
        // 2. a code a slot; slots past the matrix read as code 0
        for (int k = tid; k < ncode; k += kThreads) {
            int code = 0;
            if (k < ncur) {
                int o = o0 + k;        // DNA, protein: a slot is a byte
                if (a.mode == kOneFrame) {
                    const unsigned uk = u0 + (unsigned)k;
                    const unsigned dr = div_of(a.U, uk);
                    o = o0 + (int)((long long)dr * a.maxlen
                                   + 3LL * ((long long)(uk - dr * U) - u0));
                }
                const int c1 = sbytes[o];
                if (a.mode == kProtein) {
                    code = c1 & 31;
                } else {
                    const int c2 = o + 1 < nb ? sbytes[o + 1] : 0;
                    const int c3 = o + 2 < nb ? sbytes[o + 2] : 0;
                    const int h = ((c1 & 14) << 5) | ((c2 & 14) << 2)
                                  | ((c3 & 14) >> 1);
                    code = slut[h];         // h <= 511 < kLutMax
                }
            }
            scode[k] = (uint8_t)code;
        }
        __syncthreads();
        // 3. a pack of six letters a slot, or the folded pair under -j
        for (int k = tid; k < npack; k += kThreads) {
            int32_t v;
            if (SLOPPY) {
                v = saas[(scode[k] << 5) | scode[k + ls]];
            } else {
                v = 0;
#pragma unroll
                for (int j = 0; j < 6; ++j)
                    v |= (int32_t)scode[k + ls * j] << (5 * (5 - j));
            }
            spack[k] = v;
        }
        // the tile's windows are output rows [m0, m1): row r0's from
        // column min(u0, w) on
        const int nt = (int)min((long long)kTile, a.slots - s0);
        const unsigned w = (unsigned)a.w;
        const unsigned ke = u0 + (unsigned)nt;
        const unsigned de = div_of(a.U, ke);
        const unsigned cw0 = min(u0, w);
        const long long m0 = r0 * w + cw0;
        const long long m1 = (r0 + de) * w + min(ke - de * U, w);
        __syncthreads();
        // 4. each window's limbs from the packs
        for (int k = tid; k < nt; k += kThreads) {
            const unsigned uk = u0 + (unsigned)k;
            const unsigned dr = div_of(a.U, uk);
            const unsigned c = uk - dr * U;
            if (c >= w) continue;
            int32_t* o = sout + (int)(dr * w + c - cw0) * L;
            if (SLOPPY) {
                int32_t v = 0;
#pragma unroll
                for (int p = 0; p < 6; ++p)
                    v |= spack[k + 2 * ls * p] << (5 * (5 - p));
                o[0] = v;
                o[1] = 0;
            } else {
#pragma unroll
                for (int i = 0; i < L - 1; ++i) o[i] = spack[k + 6 * ls * i];
                o[L - 1] = spack[k + 6 * ls * (L - 1)] & a.last_mask;
            }
        }
        __syncthreads();
        // 5. the run of output words [m0 L, m1 L), 16-byte stores where
        // they are aligned
        const long long w0 = m0 * L, w1 = m1 * L;
        const long long wa = min((w0 + 3) & ~3LL, w1);
        const long long wz = max(w1 & ~3LL, wa);
        if (tid < wa - w0) a.out[w0 + tid] = sout[tid];
        if (tid < w1 - wz) a.out[wz + tid] = sout[wz - w0 + tid];
        for (long long v = wa + 4LL * tid; v < wz; v += 4LL * kThreads) {
            const int32_t* s = sout + (v - w0);
            *reinterpret_cast<int4*>(a.out + v) =
                make_int4(s[0], s[1], s[2], s[3]);
        }
    }
}

template <int L, bool SLOPPY>
int launch(const Args& a, int sms, cudaStream_t stream) {
    // the occupancy on each card, kept: the host query costs more than
    // the kernel on a small batch (not thread-safe: one host thread
    // launches on a card at a time)
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    static int per_sm[kMaxDevices];
    if (per_sm[dev] == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[dev], encode_kernel<L, SLOPPY>, kThreads, 0);
        if (err != cudaSuccess) return (int)err;
        per_sm[dev] = max(per_sm[dev], 1);
    }
    const long long blocks = min(a.tiles, (long long)per_sm[dev] * sms);
    encode_kernel<L, SLOPPY><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// mat (rows, maxlen) uint8, lut (lut_n,) int32, out (rows * w, L) int32,
// aas (1,024,) int32 or null; step 3 is one frame; sms: the card's
// multiprocessors (the persistent grid).
extern "C" int kasa_encode_windows(const void* mat, const void* lut,
                                   int lut_n, int rows, int maxlen, int w,
                                   int protein, int step, int hk,
                                   const void* aas, int sms, void* out,
                                   void* stream) {
    const int L = (hk + 5) / 6;
    if (hk < 1 || L > kMaxLimbs || lut_n < 1 || sms < 1 || maxlen < 1
            || (step != 1 && step != 3) || (protein && step != 1))
        return (int)cudaErrorInvalidValue;
    if (aas != nullptr && hk != 12) return (int)cudaErrorInvalidValue;
    const long long m = (long long)rows * w;
    if (m <= 0) return (int)cudaGetLastError();
    Args a;
    // the 4-byte loads read whole words: the matrix from the word that
    // holds its first byte (a view may start inside one)
    a.mis = (int)(reinterpret_cast<uintptr_t>(mat) & 3u);
    a.mat = (const uint8_t*)mat - a.mis;
    a.lut = (const int32_t*)lut;
    a.aas = (const int32_t*)aas;
    a.out = (int32_t*)out;
    a.maxlen = maxlen;
    a.mode = protein ? kProtein : (step == 3 ? kOneFrame : kDna);
    const int U = a.mode == kOneFrame ? maxlen / 3 : maxlen;
    a.ls = a.mode == kDna ? 3 : 1;
    a.w = w;
    a.lut_n = lut_n;
    const int last = hk - 6 * (L - 1);           // letters of the last limb
    a.last_mask = (int32_t)(~((1u << (5 * (6 - last))) - 1u));
    if (U < 1 || w > U) return (int)cudaErrorInvalidValue;
    a.U = fast_div((unsigned)U);
    a.nbytes = (long long)rows * maxlen;
    a.slots = (long long)rows * U;
    a.tiles = (a.slots + kTile - 1) / kTile;
    if (reinterpret_cast<uintptr_t>(out) & 15u)
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
    if (aas != nullptr) return launch<2, true>(a, sms, s);
    switch (L) {
        case 1: return launch<1, false>(a, sms, s);
        case 2: return launch<2, false>(a, sms, s);
        case 3: return launch<3, false>(a, sms, s);
        case 4: return launch<4, false>(a, sms, s);
        default: return launch<5, false>(a, sms, s);
    }
}
