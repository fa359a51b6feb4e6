// Native build-scan kernels: DNA -> packed k-mer windows, and the
// frequency-file counting pass.
//
// The reference's build hot loop is dnaTokMers (Read.hpp:1991-2139):
// rolling 3-frame codon translation emitting packed (k-mer, taxid)
// pairs, with windows containing the illegal letter '_' dropped.  The
// host twin (core/encode.py Encoder + index/build.py emit) costs
// ~0.4 us/window in temporaries; this pass is a single rolling scan
// at memory speed.  Semantics are identical to the numpy path (same
// 366-entry codon LUT, same '&14' codon hash, same validity rule);
// tests/test_torch_build.py checks byte parity of the artifacts.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

static inline int32_t codon_hash(uint8_t c1, uint8_t c2, uint8_t c3) {
    return ((c1 & 14) << 5) | ((c2 & 14) << 2) | ((c3 & 14) >> 1);
}

}  // namespace

extern "C" {

// seq: sanitized bytes (marker already appended), len >= 3*highest_k.
// lut366: codon-hash -> AA code (0..31; 31 = '_' illegal).
// Emits PACKED 5-bit/letter keys for every window whose 12 letters
// contain no code 31, in frame-major order (frame 0's windows, then
// frame 1's, then frame 2's -- the downstream sort makes order
// irrelevant).  frames: 3 normally, 1 under --one.  Returns the
// number of windows written to out_keys.
int64_t kasa_encode_dna(const uint8_t* seq, int64_t len,
                        const int32_t* lut366, int highest_k,
                        int frames, uint64_t* out_keys) {
    const int span = 3 * highest_k;          // chars per window
    if (len < span) return 0;
    const int64_t w = len - span + 1;        // windows (all frames)
    const int kk = highest_k;
    const uint64_t mask = (kk * 5 >= 64)
        ? ~0ull : ((1ull << (kk * 5)) - 1);
    int64_t out = 0;
    for (int f = 0; f < frames; ++f) {
        // letters for this frame sit at char positions f, f+3, ...
        uint64_t key = 0;
        int bad = 0;         // letters until the last '_' leaves
        int have = 0;        // letters accumulated so far
        for (int64_t p = f; p + 2 < len; p += 3) {
            int32_t aa = lut366[codon_hash(seq[p], seq[p + 1],
                                           seq[p + 2])];
            key = ((key << 5) | (uint64_t)(aa & 31)) & mask;
            bad = (aa == 31) ? kk : (bad > 0 ? bad - 1 : 0);
            ++have;
            if (have >= kk) {
                int64_t start = p - 3 * (kk - 1);   // window char start
                if (start < w && bad == 0)
                    out_keys[out++] = key;
            }
        }
    }
    return out;
}

// Frequency counting (GetFrequencyK, kASA.hpp:449-575): column j
// counts entries whose j-th letter FROM THE RIGHT of the packed key
// is not '^' (code 30).  rows: dense content row per entry.
// freq: (S, num_cols) uint64, caller-zeroed.
void kasa_frequencies(const uint64_t* keys, const int32_t* rows,
                      int64_t n, int num_cols, int64_t S,
                      uint64_t* freq, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    std::vector<std::vector<uint64_t>> part(
        nthreads, std::vector<uint64_t>());
    std::vector<std::thread> ths;
    for (int t = 0; t < nthreads; ++t)
        ths.emplace_back([&, t]() {
            auto& f = part[t];
            f.assign((size_t)S * num_cols, 0);
            int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
            for (int64_t i = lo; i < hi; ++i) {
                uint64_t k = keys[i];
                uint64_t* row = &f[(size_t)rows[i] * num_cols];
                for (int j = 0; j < num_cols; ++j)
                    row[j] += (((k >> (5 * j)) & 31) != 30);
            }
        });
    for (auto& th : ths) th.join();
    for (int t = 0; t < nthreads; ++t)
        for (size_t i = 0; i < (size_t)S * num_cols; ++i)
            freq[i] += part[t][i];
}

}  // extern "C"
