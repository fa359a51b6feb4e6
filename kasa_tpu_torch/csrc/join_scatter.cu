// K11 join_scatter: the join engine's score scatter.
//
// Replaces kasa_tpu/match/join.py:200 _score_scatter: every occurrence
// valid at level ki (matched and no '^', from K10) adds w(k) * (1/T),
// the float32 value kasa_tpu scatters (join.py:327-331), to its read's
// score row for each of its group's T taxa d_tax[ki][start .. start+T).
//
// kasa_tpu runs one program per level over a padded slot array of
// p_hat = next power of two of the level's (occurrence, taxon) pairs and
// finds each slot's occurrence by a search of an int32 cumsum: XLA needs
// static shapes.  Here one thread takes one (level, occurrence) and
// walks its T taxa, all levels in one launch, with 64-bit offsets: no
// pair array, no cumsum, no search.
//
// Accumulation: atomicAdd on float64 cells (the wrapper rounds to float32
// once).  A long read adds the same w(k)/T thousands of times to one
// cell, and float32 adds of a constant drift one way (K9 measured 9e-5
// relative on a 24 k-window read, PERF.md): in float64 the sum sits
// within the contract (rtol 2e-5) of the exact one.
//
// Bound on the H100: bytes and atomics.  The function's own bytes are
// the level flags, T, start and read id of every occurrence, the d_tax
// cells of the matched groups and the (R, S) score rows; the adds of one
// group's occurrences land on distinct reads' rows, but neighbouring
// threads of one level share a group and so its d_tax run (L1/L2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) join_scatter_kernel(
        const uint8_t* valid, const int32_t* T, const int32_t* start,
        const int32_t* read_ids, const int32_t* d_tax, const float* weights,
        long long M, long long tmax, int num_k, int S, double* scores) {
    const long long total = (long long)num_k * M;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         o < total; o += stride) {
        if (!valid[o]) continue;
        const int ki = (int)(o / M);
        const long long m = o - (long long)ki * M;
        const int t = T[o];
        const float val = weights[ki] * (1.0f / (float)t);
        const int32_t* taxa = d_tax + (long long)ki * tmax + start[o];
        double* srow = scores + (long long)read_ids[m] * S;
        for (int j = 0; j < t; ++j) atomicAdd(srow + taxa[j], (double)val);
    }
}

}  // namespace

extern "C" int kasa_join_scatter(
        const void* valid, const void* T, const void* start,
        const void* read_ids, const void* d_tax, const void* weights,
        long long M, long long tmax, int num_k, int S, void* scores,
        void* stream) {
    if (num_k < 1 || S < 1 || tmax < 0) return (int)cudaErrorInvalidValue;
    if (M <= 0) return (int)cudaGetLastError();
    long long blocks = ((long long)num_k * M + kThreads - 1) / kThreads;
    blocks = min(blocks, 1LL << 20);
    join_scatter_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)valid, (const int32_t*)T, (const int32_t*)start,
        (const int32_t*)read_ids, (const int32_t*)d_tax,
        (const float*)weights, M, tmax, num_k, S, (double*)scores);
    return (int)cudaGetLastError();
}
